"""The port's bundle adjustment (``sfm/bundle.py``) against the JAX package's.

Every case builds one problem in numpy (the scene generator of
``tests/test_sfm.py``: points in a box, cameras on an arc) and hands the
same arrays to both packages.  Tolerances:

* residuals, per-observation Jacobians and diag(JᵀJ): 1e-5 relative to the
  largest entry (f32 rounding of the same operations in another order);
* one Schur step: 1e-3 relative in norm (the dense solve amplifies the
  last-bit differences of the assembled system);
* full LM (schur and cg) on observations with 0.5 px noise: the final mean
  squared residual within 1e-3 relative (it is dominated by the noise, so
  both optimizers reach the same floor) and the parameters within 2e-3;
* the focal, distortion and padding-anchor cases of ``tests/test_sfm.py``
  run on the port with that file's own bounds;
* a singular reduced system: no raise, every step rejected, the same
  result as JAX's, exactly (nothing moves).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd

from tests.test_sfm import _look_at_scene
from vit_colmap_tpu.sfm import bundle as jbundle
from vit_colmap_tpu_torch.sfm import bundle


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensor operations on one intra-op thread: test workers share
    the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _arrays(n_pts, n_cams, seed=0, noise_px=0.0, pt_noise=0.05, cam_noise=0.0,
            K_scale=1.0, refine_focal=False, k1=0.0):
    """Numpy arrays of one BA problem: all images share one camera, the
    first two are gauge-fixed."""
    X, K, cams = _look_at_scene(n_pts=n_pts, n_cams=n_cams, seed=seed)
    rng = np.random.default_rng(seed + 100)
    obs_cam, obs_pt, obs_xy = [], [], []
    for i, (R, t) in enumerate(cams):
        Xc = X @ R.T + t
        xn = Xc[:, :2] / Xc[:, 2:]
        xn = xn * (1 + k1 * (xn**2).sum(-1, keepdims=True))
        uv = xn * np.diag(K)[:2] + K[:2, 2] + noise_px * rng.standard_normal((n_pts, 2))
        obs_cam += [i] * n_pts
        obs_pt += list(range(n_pts))
        obs_xy.append(uv)
    cam = np.zeros((n_cams, 6), np.float32)
    for i, (R, t) in enumerate(cams):
        cam[i, :3] = bundle.matrix_to_axis_angle(torch.tensor(R, dtype=torch.float32)).numpy()
        cam[i, 3:6] = t
    cam[2:, 3:6] += cam_noise
    K_used = K.copy()
    K_used[:2, :2] *= K_scale
    n_obs = len(obs_cam)
    return dict(
        cam_params=cam,
        focal_log=np.zeros(1, np.float32),
        points=(X + pt_noise * rng.standard_normal(X.shape)).astype(np.float32),
        obs_cam=np.asarray(obs_cam, np.int32),
        obs_point=np.asarray(obs_pt, np.int32),
        obs_xy=np.concatenate(obs_xy).astype(np.float32),
        obs_valid=np.ones(n_obs, bool),
        K=np.tile(K_used, (n_cams, 1, 1)).astype(np.float32),
        cam_of_img=np.zeros(n_cams, np.int32),
        fixed_cam_mask=np.array([True, True] + [False] * (n_cams - 2)),
        refine_focal_mask=np.full(1, refine_focal),
        dist=np.zeros((1, 2), np.float32),
        refine_dist_mask=np.array([[k1 != 0.0, False]]),
    ), X


def _jax_problem(a):
    return jbundle.BAProblem(**{k: jnp.asarray(v) for k, v in a.items()})


def _torch_problem(a):
    return bundle.BAProblem(**{
        k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
        for k, v in a.items()})


def _close(ours, ref, rtol):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours, ref, rtol=0, atol=rtol * np.abs(ref).max())


def _parts(p):
    return p.cam_params, p.focal_log, p.dist, p.points


def test_axis_angle_roundtrip_and_finite_jacobian_at_identity():
    rng = np.random.default_rng(0)
    aa = rng.standard_normal((5, 3)) * 0.8
    R = bundle.axis_angle_to_matrix(torch.tensor(aa, dtype=torch.float32))
    np.testing.assert_allclose(bundle.matrix_to_axis_angle(R).numpy(), aa, atol=1e-5)
    np.testing.assert_allclose(
        R.numpy(), np.asarray(jbundle.axis_angle_to_matrix(jnp.asarray(aa, jnp.float32))),
        atol=1e-6)
    J = jacfwd(bundle.axis_angle_to_matrix)(torch.zeros(3))
    assert torch.isfinite(J).all()
    # d R / d aa at the identity is the generator of each axis.
    np.testing.assert_allclose(J[2, 1].numpy(), [1.0, 0.0, 0.0], atol=1e-6)
    np.testing.assert_allclose(J[0, 2].numpy(), [0.0, 1.0, 0.0], atol=1e-6)
    np.testing.assert_allclose(J[1, 0].numpy(), [0.0, 0.0, 1.0], atol=1e-6)


@pytest.mark.parametrize("huber_delta", [3.0, 0.5])
def test_residuals_jacobians_and_diag_match_jax(huber_delta):
    """Noisy observations, so that part of them lie beyond the Huber delta
    (its weight is detached in the Jacobians and differentiated in the
    diagonal, in both packages)."""
    a, _ = _arrays(40, 4, seed=1, noise_px=1.5, pt_noise=0.02, cam_noise=0.03,
                   refine_focal=True, k1=-0.05)
    a["cam_params"][0, :3] = 0.0  # the identity pose: finite at theta = 0
    jp, tp = _jax_problem(a), _torch_problem(a)
    r_j, (J_j, rr_j), d_j = jax.jit(lambda p: tuple(
        f(*_parts(p), p, huber_delta) for f in (jbundle._residuals, jbundle._obs_jacobians,
                                                jbundle._jtj_diag)))(jp)
    r_t = bundle._residuals(*_parts(tp), tp, huber_delta)
    _close(r_t, r_j, 1e-5)
    J_t, rr_t = bundle._obs_jacobians(*_parts(tp), tp, huber_delta)
    assert torch.isfinite(J_t).all()
    _close(J_t, J_j, 1e-5)
    _close(rr_t, rr_j, 1e-5)
    d_t = bundle._jtj_diag(*_parts(tp), tp, huber_delta)
    _close(d_t, d_j, 1e-5)
    assert (np.abs(np.asarray(r_j)).max() > huber_delta)  # the weight is active


def test_schur_step_matches_jax():
    a, _ = _arrays(50, 4, seed=2, noise_px=0.5, cam_noise=0.04, refine_focal=True)
    jp, tp = _jax_problem(a), _torch_problem(a)
    n_img, n_cam, n_pts = 4, 1, 50
    o_f, o_d, o_p = n_img * 6, n_img * 6 + n_cam, n_img * 6 + 3 * n_cam

    def unpack(x, reshape):
        return (reshape(x[:o_f], (n_img, 6)), x[o_f:o_d], reshape(x[o_d:o_p], (n_cam, 2)),
                reshape(x[o_p:], (n_pts, 3)))

    x = np.concatenate([a["cam_params"].ravel(), a["focal_log"], a["dist"].ravel(),
                        a["points"].ravel()])
    cam_free = np.repeat(~a["fixed_cam_mask"][:, None], 6, 1).astype(np.float32)
    col_free = np.concatenate([cam_free.ravel(), [1.0, 0.0, 0.0]]).astype(np.float32)
    free = np.concatenate([cam_free.ravel(), [1.0, 0.0, 0.0],
                           np.ones(3 * n_pts)]).astype(np.float32)
    lam = 1e-4
    dx_j = jax.jit(lambda x, p, cf, fm: jbundle._schur_step(
        x, jnp.float32(lam), None, lambda v: unpack(v, jnp.reshape), p, 3.0, cf, fm,
        n_img, n_cam, n_pts))(jnp.asarray(x), jp, jnp.asarray(col_free), jnp.asarray(free))
    dx_t = bundle._schur_step(
        torch.from_numpy(x), torch.tensor(lam), lambda v: unpack(v, torch.reshape), tp,
        3.0, torch.from_numpy(col_free), torch.from_numpy(free), n_img, n_cam, n_pts)
    dx_j = np.asarray(dx_j, np.float64)
    err = np.linalg.norm(dx_t.numpy() - dx_j) / np.linalg.norm(dx_j)
    assert err < 1e-3, err
    assert np.all(dx_t.numpy()[:12] == 0.0)  # the two fixed cameras


@pytest.mark.parametrize("solver", ["schur", "cg"])
def test_bundle_adjust_matches_jax(solver):
    a, X = _arrays(60, 4, seed=3, noise_px=0.5, cam_noise=0.04)
    kw = dict(iters=15, cg_iters=30, solver=solver)
    ref = jbundle.bundle_adjust(_jax_problem(a), **kw)
    stats = {}
    ours = bundle.bundle_adjust(_torch_problem(a), stats=stats, **kw)
    msr_j, msr_t = float(ref[4]), float(ours[4])
    assert abs(msr_t - msr_j) <= 1e-3 * msr_j, (msr_t, msr_j)
    assert 0.1 < msr_t < 0.5  # the noise floor, 2 * 0.5^2 on average
    for k in (0, 3):
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(ref[k]), atol=2e-3)
    assert 1 <= stats["lm_iters"] <= 15 and stats["syncs"] == stats["lm_iters"]


def test_bundle_adjust_packed_matches_unpacked():
    a, _ = _arrays(40, 3, seed=4, noise_px=0.3)
    tp = _torch_problem(a)
    ref = bundle.bundle_adjust(tp, iters=8, solver="schur")
    bufs = bundle.pack_ba_problem(
        a["cam_params"], a["focal_log"], a["dist"], a["points"], a["obs_cam"],
        a["obs_point"], a["obs_xy"], a["obs_valid"], a["K"], a["cam_of_img"],
        a["fixed_cam_mask"], a["refine_focal_mask"], a["refine_dist_mask"])
    sizes = dict(n_img=3, n_cam=1, n_pts=40, n_obs=len(a["obs_cam"]))
    unpacked = bundle.unpack_ba_problem(*bufs, **sizes)
    for name in bundle.BAProblem._fields:
        np.testing.assert_array_equal(getattr(unpacked, name).numpy(),
                                      getattr(tp, name).numpy(), err_msg=name)
    out = bundle.bundle_adjust_packed(*bufs, **sizes, iters=8, solver="schur")
    cam, focal, dist, pts, msr = bundle.unpack_ba_result(out, 3, 1, 40)
    np.testing.assert_array_equal(cam, ref[0].numpy())
    np.testing.assert_array_equal(pts, ref[3].numpy())
    assert msr == float(ref[4])


@pytest.mark.parametrize("solver", ["schur", "cg"])
def test_bundle_adjust_refines_focal(solver):
    """``tests/test_sfm.py``'s focal case: a 10%-wrong shared focal guess
    is recovered (0.9 * exp(s) -> 1)."""
    a, _ = _arrays(80, 4, seed=5, pt_noise=0.0, K_scale=0.9, refine_focal=True)
    cam, focal, dist, pts, msr = bundle.bundle_adjust(
        _torch_problem(a), iters=30, cg_iters=40, solver=solver)
    assert float(msr) < 0.1, float(msr)
    scale = float(torch.exp(focal[0]))
    assert abs(scale - 1.0 / 0.9) < 0.05 * (1.0 / 0.9), scale


def test_bundle_adjust_refines_distortion():
    """``tests/test_sfm.py``'s distortion case: observations made with
    k1 = -0.15, BA from k = 0 with k1 free recovers it; k2 stays frozen."""
    a, _ = _arrays(80, 4, seed=7, pt_noise=0.0, k1=-0.15)
    cam, focal, dist, pts, msr = bundle.bundle_adjust(
        _torch_problem(a), iters=30, cg_iters=40)
    assert abs(float(dist[0, 0]) + 0.15) < 0.02, (float(dist[0, 0]), float(msr))
    assert float(msr) < 0.5
    assert abs(float(dist[0, 1])) < 1e-8


def test_bundle_adjust_schur_anchors_padding_distortion():
    """``tests/test_sfm.py``'s mapper-condition case: fixed anchors, padded
    observations and points, focal and k1/k2 free."""
    a, _ = _arrays(50, 4, seed=0, pt_noise=0.03)
    n_obs = len(a["obs_cam"])
    pad = lambda v, n, fill=0: np.concatenate(  # noqa: E731
        [v, np.full((n - len(v),) + v.shape[1:], fill, v.dtype)])
    a.update(points=pad(a["points"], 64), obs_cam=pad(a["obs_cam"], n_obs + 37),
             obs_point=pad(a["obs_point"], n_obs + 37),
             obs_xy=pad(a["obs_xy"], n_obs + 37),
             obs_valid=pad(a["obs_valid"], n_obs + 37, False),
             refine_focal_mask=np.ones(1, bool), refine_dist_mask=np.ones((1, 2), bool))
    tp = _torch_problem(a)
    cam, focal, dist, pts, msr = bundle.bundle_adjust(tp, iters=15, solver="schur")
    assert float(msr) < 0.05, float(msr)
    np.testing.assert_array_equal(cam[:2].numpy(), tp.cam_params[:2].numpy())
    np.testing.assert_allclose(pts[50:].numpy(), 0.0, atol=1e-6)
    assert dist.abs().max() < 0.02


def test_unknown_solver_raises():
    a, _ = _arrays(10, 3)
    with pytest.raises(ValueError, match="unknown solver"):
        bundle.bundle_adjust(_torch_problem(a), solver="lu")


def test_singular_system_rejects_steps_like_jax():
    """A free image without observations makes the reduced system singular:
    ``jnp.linalg.solve`` returns non-finite values there and LM rejects
    every step until lam passes 1e8, leaving the problem as it was; the
    port must not raise and must do the same."""
    a, _ = _arrays(30, 3, seed=1, noise_px=0.5, cam_noise=0.03)
    keep = a["obs_cam"] != 2
    for k in ("obs_cam", "obs_point", "obs_xy", "obs_valid"):
        a[k] = a[k][keep]
    ref = jbundle.bundle_adjust(_jax_problem(a), iters=20, solver="schur")
    stats = {}
    ours = bundle.bundle_adjust(_torch_problem(a), iters=20, solver="schur", stats=stats)
    assert stats["lm_iters"] == 13  # lam from 1e-4 past 1e8, x10 a step
    assert float(ours[4]) == float(ref[4])
    np.testing.assert_array_equal(ours[0].numpy(), a["cam_params"])
    np.testing.assert_array_equal(ours[3].numpy(), a["points"])
    np.testing.assert_array_equal(np.asarray(ref[0]), a["cam_params"])


@pytest.mark.parametrize("shape", [(), (3,), (3, 3)])
def test_segment_sums_equal_index_add(shape):
    """The sorted segment sums of BA equal ``index_add_`` on the CPU, where
    both add each segment's rows in their order, bit for bit, empty
    segments included; the sort is made once per key."""
    rng = np.random.default_rng(2)
    ids = torch.from_numpy(rng.integers(0, 40, 500))
    ids[ids == 7] = 8  # segment 7 stays empty
    data = torch.from_numpy(rng.standard_normal((500, *shape)).astype(np.float32))
    seg = bundle._SegmentSums()
    calls = []

    def lazy_ids():
        calls.append(1)
        return ids

    out = seg("k", data, lazy_ids, 41)
    ref = torch.zeros((41, *shape)).index_add_(0, ids, data)
    assert torch.equal(out, ref) and not out[7].any() and not out[40].any()
    assert torch.equal(seg("k", 2 * data, lazy_ids, 41), 2 * ref) and len(calls) == 1
