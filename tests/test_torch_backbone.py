"""DINOv2 backbone of the PyTorch port against the JAX package's flax model.

A tiny configuration (depth 2, embed 128, 2 heads) is initialised in flax,
carried across with ``jax_dinov2_to_torch`` and run on the same numpy input
in fp32 with eager attention.  The bound, atol 2e-4, is that of
``tests/test_convert.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_colmap_tpu.models import dinov2 as jdino
from vit_colmap_tpu_torch.models import dinov2 as tdino
from vit_colmap_tpu_torch.models.convert import jax_dinov2_to_torch

TINY = dict(embed_dim=128, depth=2, num_heads=2, mlp_ratio=4.0)


def _pair(gelu: str, grid: int = 4, attn_impl: str = "xla"):
    jcfg = jdino.ViTConfig(**TINY, pretrain_grid=grid, dtype=jnp.float32,
                           attn_impl=attn_impl, gelu=gelu)
    jmodel = jdino.DinoV2(jcfg)
    params = jmodel.init(jax.random.key(0), jnp.zeros((1, 56, 56, 3)))
    # Flax initialises LayerScale at 1e-5 and the cls token at 0, which would
    # hide the blocks; give every parameter a visible random value.
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda p: jnp.asarray(
            np.asarray(p) + 0.1 * rng.standard_normal(p.shape).astype(np.float32)
        ),
        params,
    )
    tcfg = tdino.ViTConfig(**TINY, pretrain_grid=grid, dtype=torch.float32,
                           attn_impl=attn_impl, gelu=gelu)
    tmodel = tdino.DinoV2(tcfg)
    tmodel.load_state_dict(jax_dinov2_to_torch(params))
    return jmodel, params, tmodel.eval()


@pytest.mark.parametrize("gelu", ["tanh", "erf"])
@pytest.mark.parametrize("hw", [(56, 56), (70, 98)])
def test_backbone_matches_flax(gelu, hw):
    jmodel, params, tmodel = _pair(gelu)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, *hw, 3)).astype(np.float32)
    ref = jmodel.apply(params, jnp.asarray(x))
    with torch.no_grad():
        out = tmodel(torch.from_numpy(x))
    assert out["grid"] == tuple(ref["grid"])
    for key in ("x_norm_patchtokens", "x_norm_clstoken"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=2e-4)


@pytest.mark.parametrize("impl", ["fixedmax", "flash", "auto"])
def test_attn_impls_match_flax(impl):
    """Below the kernel gate, and off the accelerator, every attn_impl is
    eager softmax in both packages."""
    jmodel, params, tmodel = _pair("tanh", attn_impl=impl)
    x = np.random.default_rng(3).standard_normal((2, 70, 98, 3)).astype(np.float32)
    ref = jmodel.apply(params, jnp.asarray(x))
    with torch.no_grad():
        out = tmodel(torch.from_numpy(x))
    for key in ("x_norm_patchtokens", "x_norm_clstoken"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=2e-4)


def test_default_attn_impl_matches_reference():
    assert tdino.ViTConfig().attn_impl == jdino.ViTConfig().attn_impl == "auto"
    assert tdino.make_backbone("vits14")[1].attn_impl == "auto"


@pytest.mark.parametrize("grid_hw", [(85, 114), (16, 16), (16, 23)])
def test_interpolate_pos_embed_matches_jax(grid_hw):
    """Upsampling 37 -> 85 x 114 (the 1190 x 1596 input) and downsampling
    37 -> 16 (a 224 input), where jax.image.resize antialiases."""
    rng = np.random.default_rng(2)
    pe = rng.standard_normal((1, 1 + 37 * 37, 8)).astype(np.float32)
    ref = jdino.interpolate_pos_embed(jnp.asarray(pe), *grid_hw, 37)
    out = tdino.interpolate_pos_embed(torch.from_numpy(pe), *grid_hw, 37)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_converted_state_dict_layout():
    _, params, tmodel = _pair("tanh")
    sd = jax_dinov2_to_torch(params)
    assert set(sd) == set(tmodel.state_dict())
    assert sd["blocks.0.attn.qkv.weight"].shape == (384, 128)
    assert sd["patch_embed.proj.weight"].shape == (128, 3, 14, 14)


def test_attention_dispatch_uses_kernel_gate(monkeypatch):
    """fixedmax_fused takes kernel 1 at N >= 1024 only, as in the reference."""
    from vit_colmap_tpu_torch.kernels import attention

    calls = []
    real = attention.attention_qkv
    monkeypatch.setattr(attention, "attention_qkv",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    cfg = tdino.ViTConfig(embed_dim=128, depth=1, num_heads=2, dtype=torch.float32,
                          attn_impl="fixedmax_fused")
    attn = tdino.Attention(cfg)
    with torch.no_grad():
        attn(torch.zeros(1, 1023, 128))
        assert calls == []
        attn(torch.zeros(1, 1024, 128))
    assert calls == [(1, 1024, 384)]


def test_fixedmax_dispatch_uses_kernel3_gate(monkeypatch):
    """fixedmax takes kernel 3 at N >= 1024 only, on the permuted heads of
    the qkv projection, as in the reference; its result is the plain
    version's on those heads."""
    from vit_colmap_tpu_torch.kernels import attention

    calls = []
    real = attention.fixed_max_attention
    monkeypatch.setattr(attention, "fixed_max_attention",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    cfg = tdino.ViTConfig(embed_dim=128, depth=1, num_heads=2, dtype=torch.float32,
                          attn_impl="fixedmax")
    attn = tdino.Attention(cfg)
    x = torch.from_numpy(
        np.random.default_rng(4).standard_normal((1, 1024, 128)).astype(np.float32))
    with torch.no_grad():
        attn(x[:, :1023])
        assert calls == []
        out = attn(x)
        qkv = tdino._linear(x, attn.qkv, torch.float32)
        ref = attention.attention_qkv_plain(qkv, 2, 64**-0.5)
        ref = tdino._linear(ref, attn.proj, torch.float32)
    assert calls == [(1, 2, 1024, 64)]
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


@pytest.mark.parametrize("impl", ["fixedmax", "flash", "auto"])
def test_unported_attention_raises(impl):
    """The three attn_impls that once raised "not ported" now build; an
    unknown one raises."""
    _, cfg = tdino.make_backbone("vits14", attn_impl=impl)
    assert cfg.attn_impl == impl
    with pytest.raises(ValueError, match="unknown attn_impl"):
        tdino.make_backbone("vits14", attn_impl=impl + "_v2")


@pytest.mark.parametrize("global_tf32", [True, False])
def test_f32_patch_embed_convolves_without_tf32(monkeypatch, global_tf32):
    """The f32 patch embedding runs with cuDNN's TF32 off whatever the
    global flag says, and the global flag is left as it was."""
    seen = []
    conv2d = tdino.F.conv2d

    def recording_conv2d(*args, **kwargs):
        seen.append(torch.backends.cudnn.allow_tf32)
        return conv2d(*args, **kwargs)

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", global_tf32)
    monkeypatch.setattr(tdino.F, "conv2d", recording_conv2d)
    model = tdino.DinoV2(tdino.ViTConfig(**TINY, dtype=torch.float32, attn_impl="xla"))
    with torch.no_grad():
        model(torch.zeros(1, 28, 28, 3))
    assert seen == [False]
    assert torch.backends.cudnn.allow_tf32 is global_tf32


def test_vitg14_raises():
    """vitg14 builds now (it raised before SwiGLU was ported), with the JAX
    package's shapes: SwiGLU hidden 2736 (w12 1536 -> 5472, w3 2736 ->
    1536), not the public ViT-g/14's 4096, and the same parameter count
    (0.886 B)."""
    shapes = jax.eval_shape(jdino.DinoV2(jdino.ViTConfig.named("vitg14")).init,
                            jax.random.key(0), jnp.zeros((1, 56, 56, 3)))["params"]
    jax_count = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes))
    with torch.device("meta"):
        model, cfg = tdino.make_backbone("vitg14")
    sd = model.state_dict()
    assert tdino.swiglu_hidden(cfg) == 2736
    for i in range(cfg.depth):
        mlp = shapes[f"blocks_{i}"]["mlp"]
        assert sd[f"blocks.{i}.mlp.w12.weight"].shape == mlp["w12"]["kernel"].shape[::-1]
        assert sd[f"blocks.{i}.mlp.w3.weight"].shape == mlp["w3"]["kernel"].shape[::-1]
    assert sd["blocks.0.mlp.w12.weight"].shape == (5472, 1536)
    assert sum(t.numel() for t in sd.values()) == jax_count
    assert 0.88e9 < jax_count < 0.89e9
