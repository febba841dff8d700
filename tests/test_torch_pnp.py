"""The port's PnP (``sfm/pnp.py``) against the JAX package's.

The reference draws its hypotheses' uniforms from a JAX key inside
``pnp_ransac``; here the same uniforms (``jax.random.uniform(key, (iters,
6))``) are passed to the port, so both packages fit the same samples.
Tolerances.  Both packages find the DLT nullspace by f32 inverse iteration
with the same start and step count, so they differ only by the rounding of
the 12 x 12 normal matrix, summed in another order, which the nullspace's
conditioning amplifies: over-determined fits (20 and 100 points) agree
within 1e-4; minimal 6-point samples, whose nullspace is ill-conditioned
(either package's fit is up to 0.5 from the truth on some samples), agree
within 1e-3 at the median, and at most 0.05 in R and 0.2 in t (t is
in scene units, the points 3-5 from the camera).  RANSAC must pick the same
inlier mask and count; R and t of the final refit over ~80 noisy inliers
agree within 5e-4 (1.5e-4 and 3.0e-4 measured at seed 2, 1e-5 at the other
seeds).  The JAX call is padded to 128 rows, as the reference's mapper
pads, and the port's is not: padding rows carry no weight.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_sfm import _look_at_scene, _project
from vit_colmap_tpu.sfm import pnp as jpnp
from vit_colmap_tpu_torch.sfm import pnp


def _scene(seed=1, n=100, n_out=20, noise=0.5):
    X, K, cams = _look_at_scene(n_pts=n)
    R, t = cams[2]
    uv, _ = _project(R, t, K, X)
    rng = np.random.default_rng(seed)
    uv = uv + noise * rng.standard_normal(uv.shape)
    uv[:n_out] = rng.uniform(0, 640, (n_out, 2))
    return uv.astype(np.float32), X.astype(np.float32), K.astype(np.float32), R, t


def test_fit_pose_dlt_matches_jax():
    uv, X, K, R, t = _scene(n_out=0, noise=0.0)
    xn = (uv - K[:2, 2]) / np.diag(K)[:2]
    rng = np.random.default_rng(3)
    minimal = rng.integers(0, len(X), (64, 6))
    subsets = np.stack([rng.permutation(len(X))[:20] for _ in range(16)])
    w = rng.uniform(0.5, 1.0, len(X)).astype(np.float32)

    def both(*args):
        Rj, tj = jax.jit(jpnp.fit_pose_dlt)(*(jnp.asarray(a) for a in args))
        Rt, tt = pnp.fit_pose_dlt(*(torch.from_numpy(a) for a in args))
        return (np.abs(Rt.numpy() - np.asarray(Rj)).reshape(len(Rt), -1).max(1),
                np.abs(tt.numpy() - np.asarray(tj)).max(1), Rt)

    for args in ((xn[subsets], X[subsets]), (xn[None], X[None], w[None])):
        dR, dt, Rt = both(*args)
        assert dR.max() < 1e-4 and dt.max() < 1e-4, (dR.max(), dt.max())
    np.testing.assert_allclose(Rt[0].numpy(), R, atol=1e-4)
    dR, dt, _ = both(xn[minimal], X[minimal])
    assert np.median(dR) < 1e-3 and np.median(dt) < 1e-3
    assert dR.max() < 0.05 and dt.max() < 0.2


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_pnp_ransac_with_jax_uniforms_matches_jax(seed):
    uv, X, K, R, t = _scene(seed=seed)
    n, n_pad, iters = len(X), 128, 512
    key = jax.random.key(seed)
    xy = np.zeros((n_pad, 2), np.float32)
    Xp = np.zeros((n_pad, 3), np.float32)
    mask = np.zeros(n_pad, bool)
    xy[:n], Xp[:n], mask[:n] = uv, X, True
    ref = jpnp.pnp_ransac(jnp.asarray(xy), jnp.asarray(Xp), jnp.asarray(mask),
                          jnp.asarray(K), key, iters=iters, max_error_px=4.0)
    u = torch.tensor(np.asarray(jax.random.uniform(key, (iters, 6))))
    ours = pnp.pnp_ransac(torch.from_numpy(uv), torch.from_numpy(X),
                          torch.ones(n, dtype=torch.bool), torch.from_numpy(K), u,
                          max_error_px=4.0)
    np.testing.assert_array_equal(ours.inlier_mask.numpy(), np.asarray(ref.inlier_mask)[:n])
    assert int(ours.num_inliers) == int(ref.num_inliers) >= 70
    np.testing.assert_allclose(ours.R.numpy(), np.asarray(ref.R), atol=5e-4)
    np.testing.assert_allclose(ours.t.numpy(), np.asarray(ref.t), atol=5e-4)
    np.testing.assert_allclose(ours.R.numpy(), R, atol=0.02)
    np.testing.assert_allclose(ours.t.numpy(), t, atol=0.05)


def test_pnp_ransac_packed_layout():
    uv, X, K, _, _ = _scene()
    n = len(X)
    u = torch.rand((256, 6), generator=torch.Generator().manual_seed(0))
    fbuf = torch.from_numpy(np.concatenate([uv.ravel(), X.ravel(), K.ravel()]))
    mask = torch.ones(n, dtype=torch.bool)
    out = pnp.pnp_ransac_packed(fbuf, mask, u, n=n, max_error_px=4.0)
    res = pnp.pnp_ransac(torch.from_numpy(uv), torch.from_numpy(X), mask,
                         torch.from_numpy(K), u, max_error_px=4.0)
    assert out.shape == (13 + n,)
    assert torch.equal(out[:9], res.R.reshape(-1)) and torch.equal(out[9:12], res.t)
    assert int(out[12]) == int(res.num_inliers)
    assert torch.equal(out[13:] > 0.5, res.inlier_mask)
