"""The trainable heads and the feature model of the port against the JAX
package's flax modules.

``FeatureHeads`` (norm "group" and "none") and ``ViTFeatureModel`` (a tiny
backbone: depth 2, embed 128, 2 heads; a 56 x 84 image) are initialised in
flax, carried across with ``jax_feature_heads_to_torch`` and
``jax_dinov2_to_torch`` and run on the same numpy input in f32.  Bounds:
every output within atol 2e-4, descriptors within 1e-5; parameter counts and
the trainable/frozen split equal to flax's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_colmap_tpu.models import dinov2 as jdino
from vit_colmap_tpu.models import feature_model as jfm
from vit_colmap_tpu_torch.models import dinov2 as tdino
from vit_colmap_tpu_torch.models import feature_model as tfm
from vit_colmap_tpu_torch.models.convert import (
    jax_dinov2_to_torch,
    jax_feature_heads_to_torch,
)

SMALL = dict(descriptor_dim=16, hidden=64, trunk_dim=32)
TINY = dict(embed_dim=128, depth=2, num_heads=2, mlp_ratio=4.0, pretrain_grid=4,
            attn_impl="xla")


def _perturbed(params, seed):
    """Flax's init (zero biases, unit norms, LayerScale 1e-5) hides parts of
    the model; give every parameter a visible random value."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: jnp.asarray(np.asarray(p) + 0.1 * rng.standard_normal(p.shape)
                              .astype(np.float32)), params)


def _assert_outputs_close(out, ref):
    assert set(out) == set(ref)
    for key in ref:
        assert tuple(out[key].shape) == ref[key].shape, key
        atol = 1e-5 if key == "descriptors" else 2e-4
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), atol=atol,
                                   err_msg=key)


@pytest.mark.parametrize("norm", ["group", "none"])
@pytest.mark.parametrize("grid", [(4, 6), (5, 7)])
def test_feature_heads_match_flax(norm, grid):
    feats = np.random.default_rng(0).standard_normal((2, *grid, 24)).astype(np.float32)
    jheads = jfm.FeatureHeads(jfm.FeatureModelConfig(**SMALL, dtype=jnp.float32, norm=norm))
    params = _perturbed(jheads.init(jax.random.key(0), jnp.asarray(feats)), 1)
    ref = jheads.apply(params, jnp.asarray(feats))
    theads = tfm.FeatureHeads(tfm.FeatureModelConfig(**SMALL, dtype=torch.float32,
                                                     norm=norm), 24)
    theads.load_state_dict(jax_feature_heads_to_torch(params))
    with torch.no_grad():
        out = theads(torch.from_numpy(feats))
    assert out["score_logits"].shape == (2, grid[0] * 14 // 4, grid[1] * 14 // 4)
    _assert_outputs_close(out, ref)


def _models():
    jcfg = jfm.FeatureModelConfig(**SMALL, dtype=jnp.float32)
    jmodel = jfm.ViTFeatureModel(jcfg, jdino.ViTConfig(**TINY, dtype=jnp.float32))
    params = _perturbed(jmodel.init(jax.random.key(0), jnp.zeros((1, 56, 56, 3))), 2)
    tmodel = tfm.ViTFeatureModel(tfm.FeatureModelConfig(**SMALL, dtype=torch.float32),
                                 tdino.ViTConfig(**TINY, dtype=torch.float32))
    tmodel.backbone.load_state_dict(jax_dinov2_to_torch(params["params"]["backbone"]))
    tmodel.heads.load_state_dict(jax_feature_heads_to_torch(params))
    return jmodel, params, tmodel.eval()


def test_feature_model_matches_flax():
    jmodel, params, tmodel = _models()
    x = np.random.default_rng(3).standard_normal((2, 56, 84, 3)).astype(np.float32)
    ref = jmodel.apply(params, jnp.asarray(x))
    with torch.no_grad():
        out = tmodel(torch.from_numpy(x))
        feats = tmodel.backbone_features(torch.from_numpy(x))
        again = tmodel.forward_from_backbone_features(feats)
    assert out["descriptors"].shape == (2, 14, 21, 16)
    _assert_outputs_close(out, ref)
    ref_heads = jmodel.apply(params, jnp.asarray(feats.numpy()),
                             method=jfm.ViTFeatureModel.forward_from_backbone_features)
    _assert_outputs_close(again, ref_heads)


def test_count_and_split_match_flax():
    _, params, tmodel = _models()
    jheads, jfrozen = jfm.split_trainable(params)
    heads, frozen = tfm.split_trainable(tmodel)
    assert tfm.count_parameters(tmodel) == jfm.count_parameters(params)
    assert tfm.count_parameters(heads) == jfm.count_parameters(jheads)
    assert tfm.count_parameters(frozen) == jfm.count_parameters(jfrozen)
    assert all(k.startswith("heads.") for k in heads)
    assert all(k.startswith("backbone.") for k in frozen)
    assert tfm.split_trainable(tmodel.state_dict())[0].keys() == heads.keys()


def test_make_feature_model_defaults():
    model, cfg, bcfg = tfm.make_feature_model("vits14")
    jmodel, jcfg, jbcfg = jfm.make_feature_model("vits14")
    assert bcfg.attn_impl == jbcfg.attn_impl == "fixedmax_fused"
    assert (cfg.hidden, cfg.trunk_dim, cfg.descriptor_dim, cfg.norm) == (
        jcfg.hidden, jcfg.trunk_dim, jcfg.descriptor_dim, jcfg.norm)
    assert model.heads.up1.deconv.weight.shape == (384, 512, 4, 4)
    assert isinstance(model.heads.up1.norm, torch.nn.GroupNorm)
    assert model.heads.up1.norm.eps == 1e-6  # flax GroupNorm's epsilon


def test_backbone_output_is_detached():
    model, _, _ = tfm.make_feature_model("vits14", dtype=torch.float32, attn_impl="xla")
    feats = model.backbone_features(torch.zeros(1, 28, 28, 3))
    assert not feats.requires_grad
    out = model(torch.zeros(1, 28, 28, 3))
    out["score_logits"].sum().backward()
    assert model.heads.kp2.weight.grad is not None
    assert model.backbone.patch_embed.proj.weight.grad is None


@pytest.mark.parametrize("global_tf32", [True, False])
def test_heads_convolve_without_tf32(monkeypatch, global_tf32):
    """Every convolution of the heads (the f32 ones above all) runs with
    cuDNN's TF32 off whatever the global flag says; the flag is left as it
    was."""
    seen = []
    conv2d, conv_t = tfm.F.conv2d, tfm.F.conv_transpose2d
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", global_tf32)
    monkeypatch.setattr(tfm.F, "conv2d", lambda *a, **k: seen.append(
        torch.backends.cudnn.allow_tf32) or conv2d(*a, **k))
    monkeypatch.setattr(tfm.F, "conv_transpose2d", lambda *a, **k: seen.append(
        torch.backends.cudnn.allow_tf32) or conv_t(*a, **k))
    heads = tfm.FeatureHeads(tfm.FeatureModelConfig(**SMALL, dtype=torch.float32), 24)
    with torch.no_grad():
        heads(torch.zeros(1, 2, 3, 24))
    assert seen == [False] * 9
    assert torch.backends.cudnn.allow_tf32 is global_tf32


def test_unknown_norm_raises():
    with pytest.raises(ValueError, match="unknown norm"):
        tfm.FeatureHeads(tfm.FeatureModelConfig(norm="batch"), 24)
