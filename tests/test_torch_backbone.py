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


def _pair(gelu: str, grid: int = 4):
    jcfg = jdino.ViTConfig(**TINY, pretrain_grid=grid, dtype=jnp.float32,
                           attn_impl="xla", gelu=gelu)
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
                           attn_impl="xla", gelu=gelu)
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


@pytest.mark.parametrize("impl", ["fixedmax", "flash", "auto"])
def test_unported_attention_raises(impl):
    with pytest.raises(NotImplementedError):
        tdino.make_backbone("vits14", attn_impl=impl)


def test_vitg14_raises():
    with pytest.raises(NotImplementedError):
        tdino.make_backbone("vitg14")
