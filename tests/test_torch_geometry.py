"""The port's ``sfm/geometry.py`` against the JAX package's, function by
function, on the same inputs made from a numpy seed (JAX runs eagerly).

Both compute in f32 with the same algorithms (inverse iteration from the
same start vectors, the same iteration counts), so results agree to f32
rounding amplified by the conditioning of each fit: bounds are stated per
test, relative to the size of the result.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_colmap_tpu.sfm import geometry as jgeom
from vit_colmap_tpu_torch.sfm import geometry as tgeom


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This file's many small tensor operations on one intra-op thread: six
    test workers share the machine's cores, and their threads' spinning
    otherwise slows such operations many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_views(rng, batch, n, planar=False):
    """``batch`` calibrated two-view problems of ``n`` points each: pixel
    correspondences (K = 500 px, 640 x 480), normalized ones, R and t."""
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    x1s, x2s, n1s, n2s, Rs, ts = [], [], [], [], [], []
    for _ in range(batch):
        aa = rng.standard_normal(3) * 0.15
        th = np.linalg.norm(aa)
        k = aa / th
        S = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        R = np.eye(3) + np.sin(th) * S + (1 - np.cos(th)) * S @ S
        t = rng.standard_normal(3) * 0.3 + np.array([0.5, 0, 0])
        z = np.full((n, 1), 4.0) if planar else rng.uniform(3, 6, (n, 1))
        X = np.concatenate([rng.uniform(-1, 1, (n, 2)), z], axis=1)
        Xc = X @ R.T + t
        n1, n2 = X[:, :2] / X[:, 2:], Xc[:, :2] / Xc[:, 2:]
        x1s.append(n1 * 500 + [320, 240])
        x2s.append(n2 * 500 + [320, 240])
        n1s.append(n1)
        n2s.append(n2)
        Rs.append(R)
        ts.append(t)
    f32 = lambda a: np.stack(a).astype(np.float32)  # noqa: E731
    return f32(x1s), f32(x2s), f32(n1s), f32(n2s), f32(Rs), f32(ts), K


def both(name, *args):
    """(JAX result, port result) of ``geometry.<name>`` as numpy arrays."""
    out_j = getattr(jgeom, name)(*(jnp.asarray(a) for a in args))
    out_t = getattr(tgeom, name)(*(torch.from_numpy(np.array(a)) for a in args))
    if isinstance(out_j, tuple):
        return [np.asarray(o) for o in out_j], [o.numpy() for o in out_t]
    return np.asarray(out_j), out_t.numpy()


def close(got, ref, rel):
    """max |got - ref| <= rel * max |ref|."""
    err = np.abs(got.astype(np.float64) - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.fixture
def views():
    return make_views(np.random.default_rng(0), 6, 40)


def test_normalize_points(views):
    x1 = views[0]
    w = (np.random.default_rng(1).random(x1.shape[:2]) > 0.2).astype(np.float32)
    (nj, Tj), (nt, Tt) = both("normalize_points", x1, w)
    close(nt, nj, 1e-6)
    close(Tt, Tj, 1e-6)


def test_smallest_eigvec_sym():
    """Inverse iteration as written: the same start vector and steps give
    the same vector, sign included."""
    rng = np.random.default_rng(2)
    A = rng.standard_normal((8, 12, 9)).astype(np.float32)
    A[:, :, -1] = A[:, :, :-1].sum(-1)  # rank 8: a true nullvector
    M = np.einsum("bni,bnj->bij", A, A)
    vj = np.asarray(jgeom._smallest_eigvec_sym(jnp.asarray(M)))
    vt = tgeom._smallest_eigvec_sym(torch.from_numpy(M)).numpy()
    close(vt, vj, 1e-4)
    assert np.abs(np.einsum("bij,bj->bi", M, vt)).max() < 1e-3 * np.abs(M).max()


def test_smallest_eigvec_sym_retries_failed_cholesky():
    """A matrix slightly off PSD fails the first factorization: both retry
    with the larger shift (the reference tests for NaN, the port reads
    cholesky_ex's info) and agree.  Where the retry fails too, both return
    NaN."""
    M = np.stack([np.diag([-1e-6, 2.0, 3.0]), np.diag([-1.0, 2.0, 3.0])]).astype(np.float32)
    vj = np.asarray(jgeom._smallest_eigvec_sym(jnp.asarray(M)))
    vt = tgeom._smallest_eigvec_sym(torch.from_numpy(M)).numpy()
    assert np.isfinite(vt[0]).all() and np.isnan(vj[1]).all() and np.isnan(vt[1]).all()
    close(vt[:1], vj[:1], 1e-5)


def test_fit_fundamental_and_sampson(views):
    x1, x2 = views[:2]
    w = np.ones(x1.shape[:2], np.float32)
    w[:, ::7] = 0.0
    Fj, Ft = both("fit_fundamental", x1, x2, w)
    close(Ft, Fj, 1e-4)
    assert np.median(both("sampson_error", Ft, x1, x2)[1]) < 1e-2
    # Errors of the same F at points moved by about 1 px.
    noisy = x2 + np.random.default_rng(8).standard_normal(x2.shape).astype(np.float32)
    ej, et = both("sampson_error", Fj, x1, noisy)
    close(et, ej, 1e-4)


def test_fit_homography_and_transfer(views):
    x1, x2 = make_views(np.random.default_rng(3), 6, 30, planar=True)[:2]
    Hj, Ht = both("fit_homography", x1, x2)
    close(Ht, Hj, 1e-4)
    assert np.median(both("homography_error", Ht, x1, x2)[1]) < 1e-2
    noisy = x2 + np.random.default_rng(9).standard_normal(x2.shape).astype(np.float32)
    ej, et = both("homography_error", Hj, x1, noisy)
    close(et, ej, 1e-4)


def test_essential_fit_projection_and_pose(views):
    *_, n1, n2, R, t, _ = views
    Ej, Et = both("fit_essential", n1, n2)
    close(Et, Ej, 1e-3)
    s = np.linalg.svd(Et.astype(np.float64), compute_uv=False)
    assert (np.abs(s[:, 0] - s[:, 1]) / s[:, 0]).max() < 1e-4
    Pj, Pt = both("project_to_essential", Ej + 0.01)
    close(Pt, Pj, 1e-4)
    (Rsj, tsj), (Rst, tst) = both("decompose_essential", Ej)
    close(Rst, Rsj, 1e-4)
    close(tst, tsj, 1e-4)
    mask = np.ones(n1.shape[:2], bool)
    (Rj, tj), (Rt, tt) = both("recover_pose_from_E", Ej, n1, n2, mask)
    close(Rt, Rj, 1e-4)
    close(tt, tj, 1e-4)
    np.testing.assert_allclose(Rt, R, atol=1e-3)
    cj, ct = both("cheirality_count", Rj, tj, n1, n2, mask)
    np.testing.assert_array_equal(ct, cj)


def test_triangulate(views):
    *_, n1, n2, R, t, _ = views
    eye = np.broadcast_to(np.eye(3, 4, dtype=np.float32), (len(R), 3, 4))
    P2 = np.concatenate([R, t[..., None]], axis=-1)
    Xj, Xt = both("triangulate", eye, P2, n1, n2)
    close(Xt, Xj, 1e-4)
    np.testing.assert_allclose(Xt[..., :2] / Xt[..., 2:], n1, atol=1e-4)


def test_rotations_and_quaternions():
    rng = np.random.default_rng(4)
    q = rng.standard_normal((20, 4)).astype(np.float32)
    Rj, Rt = both("qvec_to_rotmat", q)
    close(Rt, Rj, 1e-6)
    qj, qt = both("rotmat_to_qvec", Rj)
    close(qt, qj, 1e-6)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    np.testing.assert_allclose(qt, qn * np.sign(qn[:, :1]), atol=1e-5)
    M = Rj + 0.05 * rng.standard_normal(Rj.shape).astype(np.float32)
    Cj, Ct = both("closest_rotation", M)
    close(Ct, Cj, 1e-4)
    np.testing.assert_allclose(np.linalg.det(Ct), 1.0, atol=1e-4)


@pytest.mark.parametrize("model,params", [
    ("SIMPLE_RADIAL", [400.0, 320.0, 240.0, -0.15]),
    ("RADIAL", [400.0, 320.0, 240.0, -0.1, 0.02]),
    ("PINHOLE", [400.0, 400.0, 320.0, 240.0]),
])
def test_undistort_points(model, params):
    cam = {"model": model, "params": np.array(params), "width": 640, "height": 480}
    pts = np.random.default_rng(5).uniform(0, 640, (50, 2)).astype(np.float32)
    got = tgeom.undistort_points(pts, cam)
    np.testing.assert_array_equal(got, jgeom.undistort_points(pts, cam))
    assert got.dtype == np.float32


def test_skew_and_homog_helpers():
    t = np.random.default_rng(6).standard_normal((5, 3)).astype(np.float32)
    S = tgeom._skew(torch.from_numpy(t)).numpy()
    np.testing.assert_array_equal(S, np.asarray(jgeom._skew(jnp.asarray(t))))
    v = np.random.default_rng(7).standard_normal((5, 3)).astype(np.float32)
    np.testing.assert_allclose(np.einsum("bij,bj->bi", S, v), np.cross(t, v), atol=1e-6)
