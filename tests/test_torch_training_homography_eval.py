"""The port's HPatches homography evaluation (``utils/homography_eval.py``)
on ``tests/test_homography_eval.py``'s four cases, and against the JAX
package's on the same matches with the JAX package's RANSAC uniforms.

Bounds: reprojection errors within 1e-4 px of the JAX package's; with the
same uniforms the same inlier model, its corner error within 1e-3 px.
"""

import jax
import numpy as np
import pytest
import torch

from vit_colmap_tpu.utils import homography_eval as jhe
from vit_colmap_tpu_torch.utils.homography_eval import (
    estimate_homography_corner_error,
    evaluate_pairs,
    match_reprojection_errors,
    ransac_chunks,
)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Small tensor operations on 1 intra-op thread: test workers
    share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _planar_pair(n=100, seed=0):
    rng = np.random.default_rng(seed)
    H = np.array([[1.05, 0.02, 5.0], [-0.01, 0.98, -3.0], [1e-5, -2e-5, 1.0]])
    k1 = rng.uniform(10, 300, (n, 2)).astype(np.float32)
    h = np.concatenate([k1, np.ones((n, 1), np.float32)], 1) @ H.T
    k2 = (h[:, :2] / h[:, 2:]).astype(np.float32)
    matches = np.stack([np.arange(n)] * 2, 1)
    return k1, k2, matches, H


def test_match_errors_zero_for_perfect_matches():
    k1, k2, m, H = _planar_pair()
    errs = match_reprojection_errors(k1, k2, m, H)
    assert errs.max() < 1e-3


def test_match_errors_detect_wrong_matches():
    k1, k2, m, H = _planar_pair()
    m_bad = m.copy()
    m_bad[:20, 1] = np.roll(m_bad[:20, 1], 1)  # derange 20 matches
    errs = match_reprojection_errors(k1, k2, m_bad, H)
    assert (errs[20:] < 1e-3).all()
    assert (errs[:20] > 1.0).mean() > 0.9
    np.testing.assert_allclose(errs, jhe.match_reprojection_errors(k1, k2, m_bad, H),
                               atol=1e-4)


def test_corner_error_small_for_good_matches():
    k1, k2, m, H = _planar_pair(seed=1)
    rng = np.random.default_rng(2)
    k2n = k2 + 0.3 * rng.standard_normal(k2.shape).astype(np.float32)
    err = estimate_homography_corner_error(k1, k2n, m, H, (320, 320), device="cpu")
    assert err < 1.5, err


def test_evaluate_pairs_mma():
    k1, k2, m, H = _planar_pair(seed=3)
    m_bad = m.copy()
    m_bad[:50, 1] = np.roll(m_bad[:50, 1], 1)
    res = evaluate_pairs(
        [
            {"kpts1": k1, "kpts2": k2, "matches": m, "H": H, "image_wh": (320, 320)},
            {"kpts1": k1, "kpts2": k2, "matches": m_bad, "H": H, "image_wh": (320, 320)},
        ],
        device="cpu",
    )
    mma = res.mma
    assert mma[3.0] > 0.7  # first pair perfect, second half-corrupted
    assert res.homography_accuracy[3.0] >= 0.5
    assert "MMA" in res.summary()


def test_corner_error_matches_jax_on_its_uniforms():
    """Half the matches deranged and noise on the rest: with the JAX
    package's uniforms (``fold_in(key(seed), hypotheses done)`` per chunk),
    the port finds the same model."""
    k1, k2, m, H = _planar_pair(n=120, seed=4)
    rng = np.random.default_rng(5)
    k2 = k2 + 0.5 * rng.standard_normal(k2.shape).astype(np.float32)
    m[:60, 1] = np.roll(m[:60, 1], 7)
    n, chunk = ransac_chunks(512)
    key = jax.random.key(0)
    u = np.stack([np.asarray(jax.random.uniform(jax.random.fold_in(key, s * chunk),
                                                (chunk, 4))) for s in range(n)])
    ref = jhe.estimate_homography_corner_error(k1, k2, m, H, (320, 320), seed=0)
    out = estimate_homography_corner_error(k1, k2, m, H, (320, 320),
                                           uniforms=torch.from_numpy(u), device="cpu")
    assert np.isfinite(ref) and abs(out - ref) <= 1e-3, (out, ref)
    assert estimate_homography_corner_error(k1[:3], k2[:3], m[:3], H, (320, 320),
                                            device="cpu") == float("inf")
