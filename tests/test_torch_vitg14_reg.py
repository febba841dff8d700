"""The public DINOv2 ViT-g/14 with registers (``vitg14_reg``) on the port's
normal path: its published widths on the ``meta`` device; the port's
``DinoV2`` with SwiGLU and registers against the benchmark's plain
reference (``benchmark/reference/dinov2.py``) at a small size on the CPU,
with negative controls that the comparison must catch; ``ViTExtractor`` on
a tiny SwiGLU-with-registers entry; and the benchmark's operation counts
and MLP reader for the model."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.drivers import extract_dinov2
from benchmark.harness import inputs
from benchmark.harness.trace import Trace
from benchmark.reference import dinov2 as ref_dinov2
from benchmark.reference import vit as ref_vit
from benchmark.roofline import counts, dinov2_counts
from vit_colmap_tpu_torch.features.vit_extractor import ViTExtractor
from vit_colmap_tpu_torch.models import dinov2
from vit_colmap_tpu_torch.models.dinov2 import preprocess

CONFIGS = Path(__file__).resolve().parents[1] / "benchmark" / "configs"
WIDTH, DEPTH, HEADS, REGS = 128, 2, 2, 4
TINY_REG = dict(embed_dim=WIDTH, depth=DEPTH, num_heads=HEADS, mlp_ratio=4.0, swiglu=True,
                num_register_tokens=REGS)
REF_CFG = dict(patch_size=14, num_heads=HEADS, layer_norm_eps=1e-6, pos_embed_grid=37,
               num_hidden_layers=DEPTH, mlp="swiglu", num_register_tokens=REGS)
# The port in f32 with eager softmax against the f32 reference: rounding
# of the same operations in another order.
TOL_F32 = 2e-4
# Kernel 1's plain version (from 1,024 tokens) rounds each probability to
# bf16 (relative 2**-9), as the kernel does, also on f32 operands.
TOL_KERNEL = 5e-3


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _meta_backbone(name, **kw):
    with torch.device("meta"):
        return dinov2.make_backbone(name, **kw)


def test_vitg14_reg_has_the_published_widths():
    model, cfg = _meta_backbone("vitg14_reg")
    sd = model.state_dict()
    assert (cfg.embed_dim, cfg.depth, cfg.num_heads, cfg.num_register_tokens) == (1536, 40, 24, 4)
    assert len(model.blocks) == 40 and dinov2.swiglu_hidden(cfg) == 4096
    for i in range(cfg.depth):
        assert sd[f"blocks.{i}.mlp.w12.weight"].shape == (8192, 1536)
        assert sd[f"blocks.{i}.mlp.w3.weight"].shape == (1536, 4096)
    assert sd["register_tokens"].shape == (1, 4, 1536)
    assert sum(t.numel() for t in sd.values()) == 1_136_485_376
    # The JAX package's vitg14 keeps its 2,736 (test_vitg14_raises holds it).
    _, g = _meta_backbone("vitg14")
    assert dinov2.swiglu_hidden(g) == 2736 and g.num_register_tokens == 0


@pytest.mark.parametrize("name,passed,regs", [
    ("vitg14_reg", None, 4),  # the table's count
    ("vitg14_reg", 0, 0),  # a caller's count wins
    ("vitb14", None, 0),
    ("vitb14", 4, 4),  # chip_smoke's registers phase
])
def test_make_backbone_takes_the_tables_registers_unless_given(name, passed, regs):
    kw = {} if passed is None else {"num_register_tokens": passed}
    model, cfg = _meta_backbone(name, **kw)
    assert cfg.num_register_tokens == regs
    assert hasattr(model, "register_tokens") == bool(regs)


def _weights(model, seed):
    """The benchmark's seeded weights for ``model``, the register tokens at
    std 0.5, as the vitg14reg.extract driver draws them."""
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    w = inputs.vit_weights(shapes, WIDTH, seed, "cpu")
    g = inputs.generator(seed, "cpu", extract_dinov2.REGISTER_STREAM)
    w["register_tokens"].normal_(0.0, extract_dinov2.REGISTER_STD, generator=g)
    return w


def _port_and_reference(hw, attn_impl, seed=11):
    cfg = dinov2.ViTConfig(**TINY_REG, dtype=torch.float32, attn_impl=attn_impl)
    model = dinov2.DinoV2(cfg).eval()
    assert dinov2.swiglu_hidden(cfg) == 344
    w = _weights(model, seed)
    model.load_state_dict(w)
    img = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (*hw, 3), np.uint8))
    with torch.no_grad():
        port = model(preprocess(img[None]))["x_norm_patchtokens"][0]
    return port, img, w


def _err(port, ref):
    return (ref.reshape(-1, WIDTH) - port).abs().max().item()


@pytest.mark.parametrize("hw", [(56, 70), (644, 532)],
                         ids=["shrinking-4x5", "growing-46x38"])
@pytest.mark.parametrize("attn_impl", ["xla", "fixedmax_fused"])
def test_swiglu_with_registers_matches_the_reference(hw, attn_impl):
    port, img, w = _port_and_reference(hw, attn_impl)
    ref = ref_dinov2.features(img, w, REF_CFG)
    assert ref.shape == (hw[0] // 14, hw[1] // 14, WIDTH)
    kernel = attn_impl == "fixedmax_fused" and port.shape[0] + 1 + REGS >= \
        dinov2.KERNEL_MIN_TOKENS
    err = _err(port, ref)
    assert err < (TOL_KERNEL if kernel else TOL_F32), err


def _halves_swapped(x, w, p, cfg):
    first, second = ref_vit._lin(x, w, p + ".w12").chunk(2, dim=-1)
    return ref_vit._lin(F.silu(second) * first, w, p + ".w3")


def _registers_before_the_position_embedding(embed):
    def early(image_u8, w, cfg):
        """Registers inserted before the position embedding is added, the
        cls row of the embedding stretched over them."""
        t = embed(image_u8, w, {**cfg, "num_register_tokens": 0})
        regs = w["register_tokens"][0] + w["pos_embed"][0, :1]
        return torch.cat([t[:1], regs, t[1:]], dim=0)

    return early


@pytest.mark.parametrize("hw", [(56, 70), (644, 532)],
                         ids=["shrinking-4x5", "growing-46x38"])
@pytest.mark.parametrize("fault", ["halves_swapped", "registers_before_pos_embed"])
def test_a_wrong_reference_fails_the_tolerance(hw, fault, monkeypatch):
    port, img, w = _port_and_reference(hw, "xla")
    if fault == "halves_swapped":
        monkeypatch.setattr(ref_dinov2, "mlp", _halves_swapped)
    else:
        monkeypatch.setattr(ref_dinov2, "embed",
                            _registers_before_the_position_embedding(ref_dinov2.embed))
    err = _err(port, ref_dinov2.features(img, w, REF_CFG))
    assert err > TOL_KERNEL, err


def _recorded_spans(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.name.startswith("vc.")), key=lambda s: (s[1], -s[2]))


def test_extractor_with_registers_detects_on_the_patch_tokens_alone(monkeypatch):
    """A tiny SwiGLU entry with 4 registers through ``ViTExtractor``: its
    feature map is the reference's patch tokens (the registers dropped),
    4,096 keypoints come back from a 66 x 70 grid, and the forward opens
    one ``vc.backbone.mlp`` span a block."""
    monkeypatch.setitem(dinov2.VIT_CONFIGS, "tiny_reg", TINY_REG)
    ex = ViTExtractor(backbone="tiny_reg", max_keypoints=4096, image_batch=1,
                      dtype=torch.float32, attn_impl="xla", device="cpu")
    assert ex.cfg.num_register_tokens == REGS
    w = _weights(ex.model, 5)
    ex.model.load_state_dict(w)
    g = torch.Generator().manual_seed(0)
    ex.set_pca(torch.linalg.qr(torch.randn(WIDTH, WIDTH, generator=g))[0].numpy(),
               np.zeros(WIDTH, np.float32))
    img = np.asarray(inputs.textures(1, 924, 980, 3, "cpu"))
    fmap = ex.dense_features(img)
    assert fmap.shape == (1, 66, 70, WIDTH)
    ref = ref_dinov2.features(torch.from_numpy(img[0]), w, REF_CFG)
    assert _err(fmap[0].reshape(-1, WIDTH), ref) < TOL_F32
    out = []
    spans = _recorded_spans(lambda: out.append(ex.extract_batch(img)))
    xy, _sc, valid, desc = out[0][:4]
    assert xy.shape == (1, 4096, 2) and int(valid.sum()) == 4096
    assert (xy[0, :, 0] >= -0.5).all() and (xy[0, :, 0] <= 69.5).all()
    assert (xy[0, :, 1] >= -0.5).all() and (xy[0, :, 1] <= 65.5).all()
    assert desc.shape == (1, 4096, 128)
    (_, a, b), = [s for s in spans if s[0] == "vc.extract.forward"]
    mlp = [s for s in spans if s[0] == "vc.backbone.mlp"]
    assert len(mlp) == DEPTH and all(a <= s <= e <= b for _, s, e in mlp)


def _config(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def test_counts_give_vitg14_reg_and_agree_with_vit_forward_flops():
    g = _config("dinov2_vitg14_reg")
    assert dinov2_counts.tokens(g) == 9695
    assert dinov2_counts.forward_flops(g) / 1e12 == pytest.approx(45.08, abs=0.005)
    block = dinov2_counts.forward_flops(g) / g["num_hidden_layers"]
    assert dinov2_counts.mlp_flops(1, g) / 1e9 == pytest.approx(366.0, abs=0.05)
    assert dinov2_counts.mlp_flops(1, g) / block == pytest.approx(0.325, abs=0.005)
    vl = _config("dinov2_vitl14")
    assert dinov2_counts.tokens(vl) == 9691
    flops = dinov2_counts.forward_flops(vl)
    assert flops == pytest.approx(counts.vit_forward_flops(vl, vl["image_height"],
                                                           vl["image_width"]), rel=1e-12)
    assert flops / 1e12 == pytest.approx(15.10, abs=0.005)


def test_the_swiglu_mlp_is_bound_by_its_products():
    g = _config("dinov2_vitg14_reg")
    least = dinov2_counts.mlp_least_s(2, g)
    assert least == pytest.approx(dinov2_counts.mlp_flops(2, g) / counts.peak_flops("bf16"))
    assert dinov2_counts.mlp_bytes(2, g) / counts.PEAKS["bytes_per_s"] < 0.5 * least


def _load_reader(name):
    from benchmark.harness import manifest

    return manifest.load_file_module(manifest.metric_path(name), "metric")


def test_mlp_reader_reads_the_work_launched_inside_the_span():
    """A window of one batch of a 2-block model: the MLP spans (typed as
    operators, as the program's are) launch kernels of 3 and 5 us; a kernel
    launched outside them is not counted."""
    ev = [("bench.window", "user_annotation", 0, 100_000, 0, 1),
          ("vc.backbone.mlp", "cpu_op", 1_000, 2_000, 0, 1),
          ("vc.backbone.mlp", "cpu_op", 5_000, 6_000, 0, 1),
          ("cudaLaunchKernel", "cuda_runtime", 1_100, 1_200, 7, 1),
          ("cuLaunchKernel", "cuda_driver", 5_100, 5_200, 8, 1),
          ("cudaLaunchKernel", "cuda_runtime", 3_000, 3_100, 9, 1),
          ("gemm", "kernel", 10_000, 13_000, 7, 0),
          ("silu", "kernel", 13_000, 18_000, 8, 0),
          ("attention_kernel", "kernel", 20_000, 60_000, 9, 0)]
    reader = _load_reader("mlp_roofline_pct.vitg14reg")
    trace = Trace(ev)
    assert reader.device_s_under(trace, reader.SPAN) == pytest.approx(8e-6)
    cfg = {**_config("dinov2_vitg14_reg"), "num_hidden_layers": 2}

    class Ctx:
        pass

    ctx = Ctx()
    ctx.trace, ctx.counters, ctx.config, ctx.traffic = trace, {"batches": 1}, cfg, \
        {"image_batch": 2}
    want = 100.0 * 2 * dinov2_counts.mlp_least_s(2, cfg) / 8e-6
    assert reader.read(ctx) == pytest.approx(want)
    ctx.trace = Trace([e for e in ev if e[0] != "vc.backbone.mlp"])
    assert reader.read(ctx) is None  # a program without the span: nothing


def test_the_driver_refuses_a_model_off_the_published_widths():
    cfg = _config("dinov2_vitg14_reg")
    shapes = {k: tuple(v.shape) for k, v in _meta_backbone("vitg14_reg")[0].state_dict().items()}
    extract_dinov2.check_widths(shapes, cfg)
    jax_widths = {k: tuple(v.shape) for k, v in
                  _meta_backbone("vitg14", num_register_tokens=4)[0].state_dict().items()}
    with pytest.raises(ValueError, match="widths"):
        extract_dinov2.check_widths(jax_widths, cfg)
    with pytest.raises(ValueError, match="register_tokens"):
        extract_dinov2.check_widths({k: v for k, v in shapes.items()
                                     if k != "register_tokens"}, cfg)


@pytest.mark.gpu
def test_vitg14_reg_extracts_through_kernel_1_on_the_card():
    """``ViTExtractor(backbone="vitg14_reg")`` on the card: 1,136,485,376
    parameters, one batch of two 1190 x 1596 images through kernel 1 once a
    block (40 launches at 24 heads) with one ``vc.backbone.mlp`` span a
    block and the add-and-norm kernel at each of its 81 boundaries, 4,096
    keypoints an image on the 85 x 114 patch grid."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; run with `pytest -m gpu` on the GPU machine")
    from vit_colmap_tpu_torch.kernels import launches

    ex = ViTExtractor(backbone="vitg14_reg", image_batch=2, device="cuda")
    assert sum(p.numel() for p in ex.model.parameters()) == 1_136_485_376
    g = torch.Generator().manual_seed(0)
    ex.set_pca(torch.linalg.qr(torch.randn(1536, 128, generator=g))[0].numpy(),
               np.zeros(1536, np.float32))
    imgs = inputs.textures(2, 1190, 1596, 7, "cuda").cpu().numpy()
    ex.extract_batch(imgs)  # builds kernel 1
    launches.clear()
    out = []
    spans = _recorded_spans(lambda: out.append(ex.extract_batch(imgs)))
    assert launches["attention_qkv"] == 40
    assert launches["add_norm"] == 81
    assert [s[0] for s in spans].count("vc.backbone.mlp") == 40
    xy, _sc, valid, desc = out[0][:4]
    assert valid.sum(axis=1).tolist() == [4096, 4096] and desc.shape == (2, 4096, 128)
    assert xy[..., 0].max() <= 113.5 and xy[..., 1].max() <= 84.5
