"""The port's invariant-point sampler and batch pipeline
(``dataloader/training_sampler.py``, ``training_batch.py``) against the JAX
package's, on the same token grids, images and homographies from a seed.

The JAX package's uniforms are fed into the port's draws (``Draws``) in
the reference's key order.  ``process_batch`` runs a two-layer narrow
backbone (embed 128, 2 heads) and narrow heads in f32 on both sides, the
parameters carried across with ``models/convert``.  Bounds: coordinates,
similarities and targets within 1e-5 (the selections and masks equal),
descriptors and negatives within 1e-5, the loss within 1e-5 relative and
the heads' (and, fine-tuning, the backbone's) gradients within 1e-3 of
each tensor's largest gradient.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_colmap_tpu.dataloader import synthetic_homography as jsh
from vit_colmap_tpu.dataloader import training_batch as jb
from vit_colmap_tpu.dataloader import training_sampler as js
from vit_colmap_tpu.losses.feature_losses import total_loss as jtotal
from vit_colmap_tpu.models import dinov2 as jdino
from vit_colmap_tpu.models import feature_model as jfm
from vit_colmap_tpu_torch.dataloader import training_batch as tb
from vit_colmap_tpu_torch.dataloader import training_sampler as ts
from vit_colmap_tpu_torch.losses.feature_losses import total_loss as ttotal
from vit_colmap_tpu_torch.models import dinov2 as tdino
from vit_colmap_tpu_torch.models import feature_model as tfm
from vit_colmap_tpu_torch.models.convert import jax_dinov2_to_torch, jax_feature_heads_to_torch

@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Small tensor operations on 1 intra-op thread: test workers
    share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SMALL = dict(descriptor_dim=16, hidden=64, trunk_dim=32)
TINY = dict(embed_dim=128, depth=2, num_heads=2, mlp_ratio=4.0, pretrain_grid=4,
            attn_impl="xla")
IMAGE_HW = (70, 84)  # a 5 x 6 token grid, 17 x 21 head maps
ATOL = 1e-5
GRAD_TOL = 1e-3  # of each tensor's largest gradient


class Draws:
    """The JAX package's uniforms, handed out in order to the port's
    ``draw_uniform``."""

    def __init__(self, arrays):
        self.arrays = [np.asarray(a) for a in arrays]

    def __call__(self, shape):
        u = self.arrays.pop(0)
        assert u.shape == tuple(shape), (u.shape, shape)
        return torch.from_numpy(u.copy())


def jax_draws(key, B, K, num_in=8, num_cross=4, token=None):
    """The uniforms the JAX package's ``process_batch`` draws from ``key``:
    in-image x, y; cross-image x, y; then (``token`` = (B, cells)) the
    token loss's x, y from ``fold_in(key, 7)``."""
    k1, k2 = jax.random.split(key)
    out = []
    for k, n in ((k1, num_in), (k2, num_cross)):
        kx, ky = jax.random.split(k)
        out += [jax.random.uniform(kx, (B, K, n)), jax.random.uniform(ky, (B, K, n))]
    if token is not None:
        a, b = jax.random.split(jax.random.fold_in(key, 7))
        out += [jax.random.uniform(a, token), jax.random.uniform(b, token)]
    return out


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _homographies(seed, B=2, preset="conservative"):
    rng = np.random.default_rng(seed)
    h, w = IMAGE_HW
    return np.stack([jsh.generate_random_homography(w, h, jsh.SyntheticHomographyConfig.preset(
        preset), rng) for _ in range(B)]).astype(np.float32)


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.mark.parametrize("structure", [False, True])
def test_select_invariant_points_matches_jax(structure):
    rng = np.random.default_rng(0)
    f1 = rng.standard_normal((2, 5, 6, 16)).astype(np.float32)
    f2 = f1 + 0.5 * rng.standard_normal(f1.shape).astype(np.float32)
    H = _homographies(1, preset="aggressive")
    s2 = rng.random((2, 5, 6)).astype(np.float32) if structure else None
    ref = js.select_invariant_points(jnp.asarray(f1), jnp.asarray(f2), jnp.asarray(H), top_k=26,
                                     structure2=None if s2 is None else jnp.asarray(s2))
    out = ts.select_invariant_points(_t(f1), _t(f2), _t(H), top_k=26,
                                     structure2=None if s2 is None else _t(s2))
    np.testing.assert_array_equal(_np(out.coords2_grid), np.asarray(ref.coords2_grid))
    np.testing.assert_array_equal(_np(out.valid), np.asarray(ref.valid))
    assert 0 < _np(out.valid).sum() < out.valid.numel()
    for a, b in ((out.coords1_grid, ref.coords1_grid), (out.similarity, ref.similarity)):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=ATOL)


def _negative_inputs(seed, B=2, K=10, H=9, W=11, D=16):
    rng = np.random.default_rng(seed)
    dmap = _unit(rng.standard_normal((B, H, W, D))).astype(np.float32)
    coords = rng.uniform(0, [W - 1, H - 1], (B, K, 2)).astype(np.float32)
    anchors = _unit(rng.standard_normal((B, K, D))).astype(np.float32)
    return dmap, coords, anchors


def test_negatives_match_jax():
    dmap, coords, anchors = _negative_inputs(2)
    B, K = coords.shape[:2]
    key = jax.random.key(3)
    ref = js.generate_all_negatives(jnp.asarray(dmap), jnp.asarray(coords),
                                    jnp.asarray(anchors), key)
    out = ts.generate_all_negatives(_t(dmap), _t(coords), _t(anchors),
                                    Draws(jax_draws(key, B, K)))
    assert out.shape == ref.shape == (B, K, 16, 16)
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=ATOL)
    # Some in-image candidates were near their anchor: the antipode.
    assert np.isclose(np.einsum("bkd,bknd->bkn", anchors, _np(out)[:, :, :8]), -1.0).any()
    jxy, jsim = js.hard_negative_coords(jnp.asarray(dmap), jnp.asarray(coords),
                                        jnp.asarray(anchors))
    txy, tsim = ts.hard_negative_coords(_t(dmap), _t(coords), _t(anchors))
    np.testing.assert_array_equal(_np(txy), np.asarray(jxy))
    np.testing.assert_allclose(_np(tsim), np.asarray(jsim), atol=ATOL)
    d = np.linalg.norm(_np(txy) - coords[:, :, None], axis=-1)
    assert (d >= 16.0 / 14.0).all()


def test_hard_negatives_take_lower_index_on_ties():
    """Equal similarities: the lower cell index first, as lax.top_k."""
    dmap = np.zeros((1, 4, 5, 2), np.float32)
    dmap[..., 0] = 1.0  # every cell the same descriptor
    coords = np.array([[[0.0, 0.0]]], np.float32)
    anchors = np.array([[[1.0, 0.0]]], np.float32)
    jxy, _ = js.hard_negative_coords(jnp.asarray(dmap), jnp.asarray(coords),
                                     jnp.asarray(anchors), top_n=3)
    txy, _ = ts.hard_negative_coords(_t(dmap), _t(coords), _t(anchors), top_n=3)
    np.testing.assert_array_equal(_np(txy), np.asarray(jxy))
    np.testing.assert_array_equal(_np(txy)[0, 0], [[2, 0], [3, 0], [4, 0]])


def test_heatmap_and_structure_match_jax():
    rng = np.random.default_rng(4)
    coords = rng.uniform(-2, [22, 18], (2, 70, 2)).astype(np.float32)  # > one slice
    valid = rng.random((2, 70)) > 0.3
    ref = jb.gaussian_heatmap(jnp.asarray(coords), jnp.asarray(valid), 17, 21)
    out = tb.gaussian_heatmap(_t(coords), _t(valid), 17, 21)
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=1e-6)
    none = tb.gaussian_heatmap(_t(coords), torch.zeros(2, 70, dtype=torch.bool), 17, 21)
    assert not none.any()
    img = rng.integers(0, 256, (2, *IMAGE_HW, 3)).astype(np.uint8)
    np.testing.assert_allclose(_np(tb.image_structure_grid(_t(img), 5, 6)),
                               np.asarray(jb.image_structure_grid(jnp.asarray(img), 5, 6)),
                               atol=1e-5)


def test_dense_token_loss_matches_jax():
    rng = np.random.default_rng(5)
    f1 = rng.standard_normal((2, 5, 6, 16)).astype(np.float32)
    f2 = f1 + 0.3 * rng.standard_normal(f1.shape).astype(np.float32)
    H = _homographies(6, preset="aggressive")  # some cells leave the grid
    key = jax.random.key(7)
    k1, k2 = jax.random.split(key)
    draws = [jax.random.uniform(k1, (2, 64)), jax.random.uniform(k2, (2, 64))]

    def jloss(a, b):
        return jb.dense_token_loss(a, b, jnp.asarray(H), key, num_cells=64)

    (jl, jaux), (jg1, jg2) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        jnp.asarray(f1), jnp.asarray(f2))
    t1, t2 = _t(f1).requires_grad_(), _t(f2).requires_grad_()
    tl, taux = tb.dense_token_loss(t1, t2, _t(H), Draws(draws), num_cells=64)
    tl.backward()
    np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=1e-5)
    np.testing.assert_allclose(_np(taux["token_pos_sim"]), np.asarray(jaux["token_pos_sim"]),
                               rtol=1e-5)
    for t, j in ((t1.grad, jg1), (t2.grad, jg2)):
        assert np.abs(_np(t) - np.asarray(j)).max() <= GRAD_TOL * np.abs(np.asarray(j)).max()


def perturbed(params, seed):
    """Flax's init hides parts of the model (zero biases, unit norms,
    LayerScale 1e-5); give every parameter a visible random value."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: jnp.asarray(np.asarray(p) + 0.1 * rng.standard_normal(p.shape)
                              .astype(np.float32)), params)


def tiny_models(seed=0):
    """The JAX (backbone, params, heads, params) and the port's (backbone,
    heads) with the same parameters, f32."""
    jbb = jdino.DinoV2(jdino.ViTConfig(**TINY, dtype=jnp.float32))
    bparams = perturbed(jax.jit(jbb.init)(jax.random.key(seed), jnp.zeros((1, 56, 56, 3))),
                        seed + 1)
    jheads = jfm.FeatureHeads(jfm.FeatureModelConfig(**SMALL, dtype=jnp.float32))
    hparams = perturbed(jax.jit(jheads.init)(jax.random.key(seed), jnp.zeros((1, 5, 6, 128))),
                        seed + 2)
    tbb = tdino.DinoV2(tdino.ViTConfig(**TINY, dtype=torch.float32))
    tbb.load_state_dict(jax_dinov2_to_torch(bparams))
    theads = tfm.FeatureHeads(tfm.FeatureModelConfig(**SMALL, dtype=torch.float32), 128)
    theads.load_state_dict(jax_feature_heads_to_torch(hparams))
    return (jbb, bparams, jheads, hparams), (tbb, theads)


def tiny_batch(seed=0, B=2):
    """Smooth random images, the second warped by a random homography."""
    import cv2

    rng = np.random.default_rng(seed)
    h, w = IMAGE_HW
    im1 = np.stack([cv2.GaussianBlur(rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
                                     (0, 0), 1.2) for _ in range(B)])
    Hs = _homographies(seed + 100, B)
    im2 = np.stack([cv2.warpPerspective(i, H, (w, h)) for i, H in zip(im1, Hs)])
    return {"image1": im1, "image2": im2, "H": Hs}


BATCH_KW = dict(top_k=12)


@pytest.mark.parametrize("train_backbone", [False, True])
def test_process_batch_loss_and_gradients_match_jax(train_backbone):
    (jbb, bparams, jheads, hparams), (tbb, theads) = tiny_models()
    batch = tiny_batch()
    key = jax.random.key(9)
    B = 2
    draws = Draws(jax_draws(key, B, BATCH_KW["top_k"],
                            token=(B, 256) if train_backbone else None))

    def jloss(hp, bp):
        outs, tgts = jb.process_batch(jbb.apply, bp, jheads.apply, hp,
                                      {k: jnp.asarray(v) for k, v in batch.items()}, key,
                                      train_backbone=train_backbone, **BATCH_KW)
        token = outs.pop("token_loss", None)
        outs.pop("token_pos_sim", None)
        out = jtotal(outs, tgts)
        total = out.total + (token if token is not None else 0.0)
        return total, (outs, tgts, out.components, token)

    (jl, (jouts, jtgts, jparts, jtoken)), (jgh, jgb) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(hparams, bparams)

    tbb.requires_grad_(train_backbone)
    touts, ttgts = tb.process_batch(tbb, theads, {k: _t(v) for k, v in batch.items()},
                                    draws, train_backbone=train_backbone, **BATCH_KW)
    assert not draws.arrays  # every uniform was taken
    token = touts.pop("token_loss", None)
    touts.pop("token_pos_sim", None)
    tout = ttotal(touts, ttgts)
    tl = tout.total + (token if token is not None else 0.0)
    tl.backward()

    np.testing.assert_array_equal(_np(ttgts["kp_mask"]), np.asarray(jtgts["kp_mask"]))
    assert 0 < _np(ttgts["kp_mask"]).sum()
    for k in jtgts:  # angles of small gradients: 1e-4 rad
        np.testing.assert_allclose(_np(ttgts[k]), np.asarray(jtgts[k]),
                                   atol=1e-4 if k == "orient_target" else ATOL, err_msg=k)
    for k in jouts:
        np.testing.assert_allclose(_np(touts[k]), np.asarray(jouts[k]), atol=1e-4, err_msg=k)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=1e-5)
    for k in jparts:
        np.testing.assert_allclose(_np(tout.components[k]), np.asarray(jparts[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    assert (token is None) == (not train_backbone)

    def check_grads(module, jgrads, convert):
        ref = convert(jgrads)
        for name, p in module.named_parameters():
            g = ref[name].numpy()
            assert p.grad is not None, name
            assert np.abs(_np(p.grad) - g).max() <= GRAD_TOL * max(np.abs(g).max(), 1e-12), name

    check_grads(theads, jgh, jax_feature_heads_to_torch)
    if train_backbone:
        check_grads(tbb, jgb, jax_dinov2_to_torch)
    else:
        assert all(p.grad is None for p in tbb.parameters())
