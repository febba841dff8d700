"""The rest of the DINOv2 backbone in the port against the JAX package's
flax model: the SwiGLU MLP (vitg14's), register tokens and the int8
``QuantDense`` path.

A tiny configuration (depth 2, embed 128, 2 heads) is initialised in flax,
carried across with ``jax_dinov2_to_torch`` and run on the same numpy input
in f32 with eager attention; atol 2e-4, the bound of
``tests/test_torch_backbone.py``.  ``QuantDense``'s int32 products must
equal the reference's bit for bit, and its output within rtol 1e-6.

int8 rounds each activation to a step of max|x| / 127, so an activation
that the two packages compute 1e-7 apart can round to neighbouring
integers and move a whole token map: the int8 models are compared with each
``QuantDense`` fed the flax layer's own input (the port's own input held
within 1e-4 of it first), so that the float path between the int8 products
is what is compared.  The two
cases of ``tests/test_quantize.py`` are ported: the int8 model's parameters
are the float model's, and its tokens stay close to bf16's.
"""

import contextlib

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_colmap_tpu.models import dinov2 as jdino
from vit_colmap_tpu_torch.models import dinov2 as tdino
from vit_colmap_tpu_torch.models.convert import jax_dinov2_to_torch

TINY = dict(embed_dim=128, depth=2, num_heads=2, mlp_ratio=4.0)
VARIANTS = {
    "swiglu": dict(swiglu=True, mlp_ratio=8 / 3),
    "registers": dict(num_register_tokens=4),
    "int8": dict(quantize="int8"),
    "int8-swiglu-registers": dict(quantize="int8", swiglu=True, mlp_ratio=8 / 3,
                                  num_register_tokens=4),
}


def _pair(**extra):
    cfg = {**TINY, **extra, "pretrain_grid": 4, "attn_impl": "xla"}
    jmodel = jdino.DinoV2(jdino.ViTConfig(**cfg, dtype=jnp.float32))
    params = jmodel.init(jax.random.key(0), jnp.zeros((1, 56, 56, 3)))
    # Flax's init (LayerScale 1e-5, zero cls and registers) would hide the
    # blocks and the registers; give every parameter a visible random value.
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda p: jnp.asarray(np.asarray(p) + 0.1 * rng.standard_normal(p.shape)
                              .astype(np.float32)), params)
    tmodel = tdino.DinoV2(tdino.ViTConfig(**cfg, dtype=torch.float32))
    tmodel.load_state_dict(jax_dinov2_to_torch(params))
    return jmodel, params, tmodel.eval()


@contextlib.contextmanager
def _flax_quantdense_inputs(monkeypatch):
    """Record every flax QuantDense input, in call order, during the block;
    then feed the port's QuantDense layers those inputs, in the same order.
    Yields the list of inputs not yet fed."""
    inputs = []

    def record(next_fun, args, kwargs, context):
        if isinstance(context.module, jdino.QuantDense) and context.method_name == "__call__":
            inputs.append(torch.from_numpy(np.array(args[0], np.float32)))
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(record):
        yield inputs
    quantized = tdino.QuantDense.quantized

    def forced(self, x, dtype):
        ref = inputs.pop(0).reshape(x.shape)
        torch.testing.assert_close(x.float(), ref, rtol=0, atol=1e-4)
        return quantized(self, ref, dtype)

    monkeypatch.setattr(tdino.QuantDense, "quantized", forced)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("hw", [(56, 56), (70, 98)])
def test_backbone_variant_matches_flax(monkeypatch, variant, hw):
    jmodel, params, tmodel = _pair(**VARIANTS[variant])
    x = np.random.default_rng(1).standard_normal((2, *hw, 3)).astype(np.float32)
    with _flax_quantdense_inputs(monkeypatch) as unfed:
        ref = jmodel.apply(params, jnp.asarray(x))
    assert len(unfed) == (8 if "int8" in variant else 0)  # 4 a block
    with torch.no_grad():
        out = tmodel(torch.from_numpy(x))
    assert not unfed
    assert out["grid"] == tuple(ref["grid"])
    assert out["x_norm_patchtokens"].shape[1] == hw[0] // 14 * (hw[1] // 14)
    for key in ("x_norm_patchtokens", "x_norm_clstoken"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=2e-4)


def test_converted_state_dict_has_swiglu_and_registers():
    _, params, tmodel = _pair(**VARIANTS["int8-swiglu-registers"])
    sd = jax_dinov2_to_torch(params)
    assert set(sd) == set(tmodel.state_dict())
    hidden = tdino.swiglu_hidden(tmodel.cfg)
    assert sd["blocks.0.mlp.w12.weight"].shape == (2 * hidden, 128)
    assert sd["blocks.0.mlp.w3.weight"].shape == (128, hidden)
    assert sd["register_tokens"].shape == (1, 4, 128)
    assert isinstance(tmodel.blocks[0].mlp.w12, tdino.QuantDense)


@pytest.mark.parametrize("rows", [5, 17, 300])
def test_quantdense_matches_flax(monkeypatch, rows):
    """The int32 products bit for bit (captured from the flax module's own
    ``dot_general``), the output within rtol 1e-6; 5 rows also take the
    port's padding to the 17 rows the card's int8 product needs."""
    rng = np.random.default_rng(rows)
    x = (rng.standard_normal((rows, 96)) * 3).astype(np.float32)
    jlayer = jdino.QuantDense(40, dtype=jnp.float32)
    params = jlayer.init(jax.random.key(1), jnp.asarray(x))
    params = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32)), params)
    captured = []
    dot_general = jax.lax.dot_general
    monkeypatch.setattr(jax.lax, "dot_general",
                        lambda *a, **k: captured.append(dot_general(*a, **k)) or captured[-1])
    ref = np.asarray(jlayer.apply(params, jnp.asarray(x)))
    monkeypatch.undo()

    layer = tdino.QuantDense(96, 40)
    with torch.no_grad():
        layer.weight.copy_(torch.from_numpy(np.asarray(params["params"]["kernel"]).T.copy()))
        layer.bias.copy_(torch.from_numpy(np.array(params["params"]["bias"])))
        acc, _, _ = layer.accumulate(torch.from_numpy(x))
        out = layer.quantized(torch.from_numpy(x), torch.float32)
    assert len(captured) == 1 and acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), np.asarray(captured[0]))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())


def test_quantdense_scales_round_half_to_even():
    layer = tdino.QuantDense(2, 1)
    with torch.no_grad():
        layer.weight.copy_(torch.tensor([[127.0, 0.5]]))  # scale 1: 0.5 -> 0
        w8, s_w = layer.weight_int8()
        assert s_w.item() == 1.0 and w8.tolist() == [[127, 0]]
        layer.weight.copy_(torch.tensor([[127.0, 1.5]]))  # 1.5 -> 2
        assert layer.weight_int8()[0].tolist() == [[127, 2]]


def test_param_tree_identical():
    """Port of tests/test_quantize.py::test_param_tree_identical: the int8
    model's state dict is the float model's, key for key, and the same seed
    gives the same values."""
    m16, _ = tdino.make_backbone("vits14", generator=torch.Generator().manual_seed(0))
    m8, _ = tdino.make_backbone("vits14", quantize="int8",
                                generator=torch.Generator().manual_seed(0))
    s16, s8 = m16.state_dict(), m8.state_dict()
    assert list(s16) == list(s8)
    for k in s16:
        torch.testing.assert_close(s8[k], s16[k], rtol=0, atol=0)


def test_int8_tokens_close_to_bf16():
    """Port of tests/test_quantize.py::test_int8_tokens_close_to_bf16, with
    its bars (cosine per token: mean > 0.995, min > 0.97)."""
    m16, _ = tdino.make_backbone("vits14", generator=torch.Generator().manual_seed(1))
    m8, _ = tdino.make_backbone("vits14", quantize="int8")
    m8.load_state_dict(m16.state_dict())
    x = torch.from_numpy(
        np.random.default_rng(0).standard_normal((1, 112, 112, 3)).astype(np.float32))
    with torch.no_grad():
        t16 = m16(x)["x_norm_patchtokens"].float()
        t8 = m8(x)["x_norm_patchtokens"].float()
    cos = torch.nn.functional.cosine_similarity(t16, t8, dim=-1)
    assert cos.mean() > 0.995, cos.mean()
    assert cos.min() > 0.97, cos.min()


def test_registers_sit_between_cls_and_patches():
    """The first block sees cls + its pos-embed, then the register tokens
    as they are (no pos-embed), then the patches."""
    _, _, tmodel = _pair(**VARIANTS["registers"])
    seen = []
    tmodel.blocks[0].register_forward_pre_hook(lambda m, a: seen.append(a[0]))
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((1, 56, 56, 3))
                         .astype(np.float32))
    with torch.no_grad():
        tmodel(x)
        pos = tdino.interpolate_pos_embed(tmodel.pos_embed, 4, 4, 4)
        torch.testing.assert_close(seen[0][0, 1:5], tmodel.register_tokens[0])
        torch.testing.assert_close(seen[0][0, 0], tmodel.cls_token[0, 0] + pos[0, 0])
    assert seen[0].shape == (1, 1 + 4 + 16, 128)


def test_unknown_quantize_raises():
    with pytest.raises(ValueError, match="unknown quantize"):
        tdino.make_backbone("vits14", quantize="fp8")


def test_make_backbone_takes_register_tokens():
    model, cfg = tdino.make_backbone("vits14", num_register_tokens=4)
    assert cfg.num_register_tokens == 4
    assert model.register_tokens.shape == (1, 4, 384)
    _, jcfg = jdino.make_backbone("vits14", num_register_tokens=4)
    assert jcfg.num_register_tokens == 4


def test_quantdense_keeps_linear_parameters():
    """Every checkpoint path is untouched: QuantDense's parameters are
    nn.Linear's."""
    assert (tdino.QuantDense(8, 4).state_dict().keys()
            == torch.nn.Linear(8, 4).state_dict().keys())
