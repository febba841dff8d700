"""The plain reference against the port at tiny widths on the CPU, with
shared weights: the ViT forward against ``DinoV2``, the matcher against the
port's plain matcher.  The test imports both; the reference imports nothing
of the port."""

import numpy as np
import pytest
import torch

from benchmark.harness import inputs
from benchmark.reference import match as ref_match
from benchmark.reference import vit as ref_vit


def _port(width, depth, heads, attn_impl):
    from vit_colmap_tpu_torch.models.dinov2 import DinoV2, ViTConfig

    cfg = ViTConfig(embed_dim=width, depth=depth, num_heads=heads, dtype=torch.float32,
                    attn_impl=attn_impl)
    return DinoV2(cfg).eval()


@pytest.mark.parametrize("hw,attn_impl,tol", [
    ((56, 70), "xla", 2e-4),  # a grid smaller than 37: the resize shrinks
    ((644, 532), "xla", 2e-4),  # 46 x 38: the resize grows
    # Kernel 1's plain version at 1,749 tokens rounds each probability to
    # bf16 (relative 2**-9), as the kernel does, also on f32 operands.
    ((644, 532), "fixedmax_fused", 5e-3),
])
def test_vit_forward_matches_dinov2(hw, attn_impl, tol):
    from vit_colmap_tpu_torch.models.dinov2 import preprocess

    width, depth, heads = 128, 2, 2
    model = _port(width, depth, heads, attn_impl)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    w = inputs.vit_weights(shapes, width, 11, "cpu")
    model.load_state_dict(w)
    img = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (*hw, 3), np.uint8))
    with torch.no_grad():
        port = model(preprocess(img[None]))["x_norm_patchtokens"][0]
    cfg = dict(patch_size=14, num_heads=heads, layer_norm_eps=1e-6, pos_embed_grid=37,
               gelu="tanh", num_hidden_layers=depth)
    ref = ref_vit.features(img, w, cfg)
    assert ref.shape == (hw[0] // 14, hw[1] // 14, width)
    err = (ref.reshape(-1, width) - port).abs().max().item()
    assert err < tol, err


def test_outlier_channels_are_drawn_into_the_block_norms():
    shapes = {"blocks.0.norm1.weight": (256,), "blocks.0.norm2.weight": (256,),
              "norm.weight": (256,)}
    w = inputs.vit_weights(shapes, 256, 3, "cpu")
    assert (w["blocks.0.norm1.weight"].abs() > 4).sum() > 0
    assert (w["norm.weight"].abs() > 4).sum() == 0


def test_inputs_repeat_for_a_seed_and_take_large_seeds():
    a = inputs.textures(2, 28, 42, 2**40 + 3, "cpu")
    b = inputs.textures(2, 28, 42, 2**40 + 3, "cpu")
    assert a.dtype == torch.uint8 and torch.equal(a, b)
    assert not torch.equal(a, inputs.textures(2, 28, 42, 2**40 + 4, "cpu"))


def test_matcher_matches_the_ports_plain_matcher():
    from vit_colmap_tpu_torch.ops.matching import match_pairs_batched

    desc = inputs.arc_scene(3, 256, 128, 192, 3, (0.3, 0.9), 5, "cpu")
    valid = torch.ones(3, 256, dtype=torch.bool)
    d = ref_match.decode(desc, valid)
    i1, i2 = torch.tensor([0, 0, 1]), torch.tensor([1, 2, 2])
    ref = ref_match.mutual(ref_match.similarity(d[i1], d[i2], "f64"), valid[i1], valid[i2],
                           0.8, 0.7)["match"]
    port = match_pairs_batched(d[i1].float(), d[i2].float(), valid[i1], valid[i2], 0.8, 0.7)
    assert (ref >= 0).sum() > 50
    assert torch.equal(ref.int(), port)


def test_reference_in_the_programs_place_has_its_signature():
    desc = inputs.arc_scene(2, 128, 128, 96, 2, (0.3, 0.9), 6, "cpu")
    valid = torch.ones(2, 128, dtype=torch.bool)
    d = ref_match.decode(desc, valid).float()
    m = ref_match.pair_matcher("bf16")(d[:1], d[1:], valid[:1], valid[1:], 0.8, 0.7, True)
    assert m.dtype == torch.int32 and m.shape == (1, 128)
