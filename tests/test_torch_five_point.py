"""The port's five-point solver against the JAX package's.

The JAX solver is compiled once, for one batch shape (60 problems of 5
points, the shape ``tests/test_five_point.py`` compiles), in a
module-scoped fixture.  The port builds the constraint tensor by tensor
algebra where the reference expands it symbolically: the same polynomial
with another rounding, so spurious (ill-conditioned) roots may move while
genuine solutions agree.  Bounds are stated in each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_colmap_tpu.sfm import five_point as jfp
from vit_colmap_tpu_torch.ops.ransac import draw_uniforms, estimate_two_view
from vit_colmap_tpu_torch.sfm import five_point as tfp

TRIALS = 60


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This file's many small tensor operations on one intra-op thread: six
    test workers share the machine's cores, and their threads' spinning
    otherwise slows such operations many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_pair(rng, n=5, noise=0.0):
    """A calibrated pair of n normalized correspondences and its unit E
    (the generator of ``tests/test_five_point.py``)."""
    aa = rng.standard_normal(3) * 0.3
    th = np.linalg.norm(aa)
    k = aa / max(th, 1e-9)
    K_ = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = np.eye(3) + np.sin(th) * K_ + (1 - np.cos(th)) * K_ @ K_
    t = rng.standard_normal(3)
    t /= np.linalg.norm(t)
    X = rng.uniform(-1, 1, (n, 3))
    X[:, 2] = rng.uniform(2, 6, n)
    p1 = X[:, :2] / X[:, 2:3]
    Xc = (R @ X.T).T + t
    p2 = Xc[:, :2] / Xc[:, 2:3]
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    E = tx @ R
    E /= np.linalg.norm(E)
    if noise:
        p1 = p1 + rng.standard_normal(p1.shape) * noise
        p2 = p2 + rng.standard_normal(p2.shape) * noise
    return p1.astype(np.float32), p2.astype(np.float32), E.astype(np.float32)


def sign_free_dist(A, B):
    return min(np.linalg.norm(A - B), np.linalg.norm(A + B))


def best_err(cands, valid, E_true):
    return min((sign_free_dist(c, E_true) for c, v in zip(cands, valid) if v),
               default=np.inf)


def epipolar_residual(E, p1, p2):
    x1 = np.concatenate([p1, np.ones((len(p1), 1))], 1)
    x2 = np.concatenate([p2, np.ones((len(p2), 1))], 1)
    return np.abs(np.einsum("ni,ij,nj->n", x2, E.astype(np.float64), x1)).max()


@pytest.fixture(scope="module")
def solved():
    """60 random minimal problems through both solvers."""
    rng = np.random.default_rng(0)
    p1, p2, E = (np.stack(a) for a in zip(*[make_pair(rng) for _ in range(TRIALS)]))
    Ej, vj = jax.jit(jfp.fit_essential_5pt)(jnp.asarray(p1), jnp.asarray(p2))
    Et, vt = tfp.fit_essential_5pt(torch.from_numpy(p1), torch.from_numpy(p2))
    return p1, p2, E, np.asarray(Ej), np.asarray(vj), Et.numpy(), vt.numpy()


def test_constraint_tensor_matches_reference():
    """The tensor-form constraints equal the reference's symbolic expansion
    to f32 rounding: max |diff| <= 1e-5 x max |coefficient|."""
    B = np.random.default_rng(3).standard_normal((3, 4, 3, 3)).astype(np.float32)
    ref = np.asarray(jfp._constraint_tensor(*(jnp.asarray(B[:, k]) for k in range(4))))
    got = tfp._constraint_tensor(torch.from_numpy(B)).numpy()
    assert got.shape == ref.shape == (3, 10, 10, 4)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    # Cells that no cubic term reaches are exactly zero in both.
    np.testing.assert_array_equal(got == 0, ref == 0)


def test_det10_matches_float64():
    M = np.random.default_rng(4).standard_normal((40, 10, 10)).astype(np.float32)
    ref = np.linalg.det(M.astype(np.float64))
    got = tfp._det10(torch.from_numpy(M)).numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_real_roots_match_reference():
    """Polynomials with known real roots: the same cells found (valid mask
    equal) and roots within 1e-5 of the reference's."""
    rng = np.random.default_rng(5)
    coeffs = []
    for n_real in (0, 2, 4, 6, 10):
        # Separated real roots in (-4.5, 4.5), the rest in irreducible
        # quadratics z^2 + a z + b (a^2 < 4b).
        p = np.poly(np.linspace(-4, 4, n_real) + rng.uniform(-0.2, 0.2, n_real))
        for _ in range((10 - n_real) // 2):
            a = rng.uniform(-1, 1)
            p = np.polymul(p, [1.0, a, a * a / 4 + rng.uniform(0.5, 2)])
        coeffs.append(p[::-1] / np.abs(p).max())  # lowest degree first
    c = np.stack(coeffs).astype(np.float32)
    rj, vj = (np.asarray(a) for a in jfp._real_roots(jnp.asarray(c)))
    rt, vt = (a.numpy() for a in tfp._real_roots(torch.from_numpy(c)))
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_allclose(rt[vt], rj[vj], atol=1e-5)


def test_genuine_candidates_match_reference(solved):
    """Candidates that solve their problem (epipolar residual on the 5
    points below 1e-5): each has a valid counterpart on the other side
    within 1e-2 (up to sign), and at least 95% within 1e-3.  All valid
    candidates: at least 85% of the reference's have a port counterpart
    within 5e-2 (spurious roots move with rounding)."""
    p1, p2, _, Ej, vj, Et, vt = solved

    def matched(A, va, B, vb, genuine_only):
        dists = []
        for i in range(TRIALS):
            for j in np.nonzero(va[i])[0]:
                if genuine_only and epipolar_residual(A[i, j], p1[i], p2[i]) >= 1e-5:
                    continue
                dists.append(min((sign_free_dist(A[i, j], B[i, k])
                                  for k in np.nonzero(vb[i])[0]), default=np.inf))
        return np.array(dists)

    for A, va, B, vb in ((Ej, vj, Et, vt), (Et, vt, Ej, vj)):
        d = matched(A, va, B, vb, genuine_only=True)
        assert len(d) > 2 * TRIALS
        assert (d < 1e-2).all() and (d < 1e-3).mean() >= 0.95
    assert (matched(Ej, vj, Et, vt, genuine_only=False) < 5e-2).mean() >= 0.85
    assert abs(int(vt.sum()) - int(vj.sum())) <= 0.05 * vj.sum()


def test_recovers_true_essential_as_reference(solved):
    """The reference's minimal-case bounds (at least 80% recovered within
    5e-2, median error below 5e-3), and the port recovers E wherever the
    reference does."""
    _, _, E, Ej, vj, Et, vt = solved
    ej = np.array([best_err(Ej[i], vj[i], E[i]) for i in range(TRIALS)])
    et = np.array([best_err(Et[i], vt[i], E[i]) for i in range(TRIALS)])
    assert np.mean(et < 5e-2) >= 0.8 and np.median(et) < 5e-3
    assert ((et < 5e-2) | (ej >= 5e-2)).all()


def test_candidates_satisfy_essential_constraints():
    p1, p2, _ = make_pair(np.random.default_rng(1))
    E, valid = tfp.fit_essential_5pt(torch.from_numpy(p1), torch.from_numpy(p2))
    E, valid = E.numpy(), valid.numpy()
    assert E.shape == (20, 3, 3) and valid.any()
    for j in np.nonzero(valid)[0]:
        s = np.linalg.svd(E[j].astype(np.float64), compute_uv=False)
        assert abs(np.linalg.norm(E[j]) - 1.0) < 1e-3
        assert s[2] < 5e-3
        assert abs(s[0] - s[1]) < 5e-2


def _lone_pair(rng, n_in, n_out):
    p1, p2, _ = make_pair(rng, n=n_in)
    pts1 = np.concatenate([p1, rng.uniform(-1, 1, (n_out, 2)).astype(np.float32)])
    pts2 = np.concatenate([p2, rng.uniform(-1, 1, (n_out, 2)).astype(np.float32)])
    perm = rng.permutation(n_in + n_out)
    return pts1[perm], pts2[perm], perm < n_in


def test_five_point_ransac_at_low_inlier_ratio():
    """The reference's RANSAC case at 30% inliers (24 of 80, normalized
    coordinates): 2,048 hypotheses recover nearly all true inliers."""
    pts1, pts2, is_inlier = _lone_pair(np.random.default_rng(2), 24, 56)
    K = torch.eye(3)
    kw = dict(iters=2048, five_point=True)
    res = estimate_two_view(
        torch.from_numpy(pts1), torch.from_numpy(pts2), torch.ones(80, dtype=torch.bool),
        K, K, True, draw_uniforms(1, torch.Generator().manual_seed(0), **kw),
        max_error_px=2e-3, min_num_inliers=10, **kw)
    inl = res.inlier_mask.numpy()
    assert inl[is_inlier].sum() >= 24 - 2
    assert inl[~is_inlier].sum() <= 4


def test_eight_point_fallback_still_works():
    p1, p2, _ = make_pair(np.random.default_rng(3), n=40)
    K = torch.eye(3)
    kw = dict(iters=128, five_point=False)
    res = estimate_two_view(
        torch.from_numpy(p1), torch.from_numpy(p2), torch.ones(40, dtype=torch.bool),
        K, K, True, draw_uniforms(1, torch.Generator().manual_seed(0), **kw),
        max_error_px=2e-3, min_num_inliers=10, **kw)
    assert int(res.num_inliers) >= 35
