"""The port's homography decomposition (``sfm/geometry.decompose_homography``)
against OpenCV's ``decomposeHomographyMat``, which the JAX package's mapper
calls for its init-pair candidates and which the port may not import.

Twenty plane-induced homographies H = K (R + t nᵀ / d) K⁻¹ with random
poses, planes and scales, half of them refitted from noisy correspondences
by the port's DLT as the mapper fits them, and two special cases (a pure
rotation, a near fronto-parallel plane).  Both must give the same number of
solutions in the same order, with R, t and n within 1e-6 (float64 in both;
OpenCV takes one square root in single precision, and so does the port).
"""

import cv2
import numpy as np
import pytest
import torch

from vit_colmap_tpu_torch.sfm import geometry


def _rotation(rng, scale):
    w = rng.standard_normal(3) * scale
    R, _ = cv2.Rodrigues(w)
    return R


def _plane_homography(seed):
    rng = np.random.default_rng(seed)
    K = np.array([[rng.uniform(400, 900), 0, rng.uniform(300, 340)],
                  [0, rng.uniform(400, 900), rng.uniform(220, 260)], [0, 0, 1]])
    R = _rotation(rng, 0.2)
    t = rng.standard_normal(3) * 0.5
    n = rng.standard_normal(3) * 0.3 + [0, 0, 1.0]
    n /= np.linalg.norm(n)
    d = rng.uniform(3.0, 6.0)
    H = K @ (R + np.outer(t, n) / d) @ np.linalg.inv(K)
    H *= rng.uniform(0.2, 5.0) * rng.choice([-1.0, 1.0])
    if seed % 2:  # refit from noisy correspondences, as the mapper does
        x1 = rng.uniform([0, 0], [640, 480], (200, 2))
        h = np.c_[x1, np.ones(200)] @ H.T
        x2 = h[:, :2] / h[:, 2:] + 0.5 * rng.standard_normal((200, 2))
        H = geometry.fit_homography(torch.tensor(x1, dtype=torch.float32)[None],
                                    torch.tensor(x2, dtype=torch.float32)[None])[0]
        H = H.numpy().astype(np.float64)
        K = K.astype(np.float32)  # the mapper's K (camera_matrix) is f32
    return H, K


def _check(H, K):
    n_cv, Rs_cv, ts_cv, ns_cv = cv2.decomposeHomographyMat(H, K)
    Rs, ts, ns = geometry.decompose_homography(H, K)
    assert len(Rs) == n_cv
    for k in range(n_cv):
        np.testing.assert_allclose(Rs[k], Rs_cv[k], rtol=0, atol=1e-6)
        np.testing.assert_allclose(ts[k], ts_cv[k].ravel(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(ns[k], ns_cv[k].ravel(), rtol=0, atol=1e-6)
    return n_cv


@pytest.mark.parametrize("seed", range(20))
def test_decomposition_matches_opencv(seed):
    assert _check(*_plane_homography(seed)) == 4


def test_pure_rotation_gives_one_motion():
    rng = np.random.default_rng(5)
    K = np.array([[600.0, 0, 320], [0, 600.0, 240], [0, 0, 1]])
    H = 2.5 * K @ _rotation(rng, 0.1) @ np.linalg.inv(K)
    assert _check(H, K) == 1


def test_fronto_parallel_plane():
    K = np.array([[600.0, 0, 320], [0, 600.0, 240], [0, 0, 1]])
    H = K @ (np.eye(3) + np.outer([0.3, 0.0, 0.0], [0, 0, 1.0]) / 4.0) @ np.linalg.inv(K)
    assert _check(H, K) == 4
