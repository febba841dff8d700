"""The port's batched RANSAC (``ops/ransac.py``) against the JAX package's.

The reference draws its samples from JAX keys: ``split(key, 3)`` gives the
F, H and E keys, ``split`` of the E key the 8-point seed's and the 5-point
loop's, and chunk ``s`` of a loop draws ``uniform(fold_in(k, it_done),
(chunk, m))``.  :func:`jax_uniforms` lays those uniforms out as the port's
``RansacUniforms``, so both packages fit the same samples.

The JAX estimator is compiled once (one lane of 256 correspondences, 512
hypotheses, the 5-point solver on) in a module-scoped fixture; every case
of ``tests/test_geometry.py`` runs at that shape.
"""

from collections import Counter

import jax
import numpy as np
import pytest
import torch

from vit_colmap_tpu.ops import ransac as jransac
from vit_colmap_tpu_torch.database import TWO_VIEW_CONFIG
from vit_colmap_tpu_torch.ops import ransac
from vit_colmap_tpu_torch.sfm import geometry as tgeom

K_MAX, ITERS = 256, 512


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This file's many small tensor operations on one intra-op thread: six
    test workers share the machine's cores, and their threads' spinning
    otherwise slows such operations many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_uniforms(key, iters=ITERS, five_point=True) -> ransac.RansacUniforms:
    """The uniforms the reference's ``estimate_two_view`` draws from ``key``,
    in the port's layout (one lane)."""
    plan = ransac.chunk_plan(iters, five_point=five_point)
    kf, kh, ke = jax.random.split(key, 3)
    keys = {"f": kf, "h": kh, "e": ke}
    if five_point:
        keys["e"], keys["e5"] = jax.random.split(ke)
    streams = {}
    for name, (n, chunk, m, start) in plan.items():
        streams[name] = torch.from_numpy(np.stack([
            np.asarray(jax.random.uniform(
                jax.random.fold_in(keys[name], start + s * chunk), (chunk, m)))
            for s in range(n)]))
    return ransac.RansacUniforms(f=streams["f"], h=streams["h"], e=streams["e"],
                                 e5=streams.get("e5"))


def make_two_view(n=100, noise=0.0, seed=0, planar=False):
    """A calibrated two-view scene (the generator of tests/test_geometry.py):
    pixel correspondences, K, R, t."""
    rng = np.random.default_rng(seed)
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    z = np.full((n, 1), 4.0) if planar else rng.uniform(3.0, 6.0, (n, 1))
    X = np.concatenate([rng.uniform(-1, 1, (n, 2)), z], axis=1)
    angle = 0.15
    R = np.array([[np.cos(angle), 0, np.sin(angle)], [0, 1, 0],
                  [-np.sin(angle), 0, np.cos(angle)]])
    t = np.array([0.5, 0.05, 0.02])

    def project(P, X):
        x = (P[:, :3] @ X.T).T + P[:, 3]
        return (K @ x.T).T[:, :2] / (K @ x.T).T[:, 2:]

    P1 = np.concatenate([np.eye(3), np.zeros((3, 1))], axis=1)
    P2 = np.concatenate([R, t[:, None]], axis=1)
    x1 = project(P1, X) + noise * rng.standard_normal((n, 2))
    x2 = project(P2, X) + noise * rng.standard_normal((n, 2))
    return x1.astype(np.float32), x2.astype(np.float32), K.astype(np.float32), R, t


def _padded(x1, x2, k_max=K_MAX):
    n = len(x1)
    p1 = np.zeros((k_max, 2), np.float32)
    p2 = np.zeros((k_max, 2), np.float32)
    p1[:n], p2[:n] = x1, x2
    return p1, p2, np.arange(k_max) < n


def _cases():
    """name -> (pts1, pts2, mask, K, calibrated, key seed, R, t): the cases of
    tests/test_geometry.py, each padded to K_MAX."""
    out = {}
    x1, x2, K, R, t = make_two_view(150, noise=0.3, seed=1)
    rng = np.random.default_rng(2)
    x1 = np.concatenate([x1, rng.uniform(0, 640, (50, 2)).astype(np.float32)])
    x2 = np.concatenate([x2, rng.uniform(0, 480, (50, 2)).astype(np.float32)])
    out["outliers"] = (*_padded(x1, x2), K, True, 0, R, t)
    x1, x2, K, R, t = make_two_view(120, noise=0.2, seed=3, planar=True)
    out["planar"] = (*_padded(x1, x2), K, True, 1, R, t)
    rng = np.random.default_rng(5)
    Kd = np.diag([100.0, 100.0, 1.0]).astype(np.float32)
    p1 = rng.uniform(0, 100, (64, 2)).astype(np.float32)
    p2 = rng.uniform(0, 100, (64, 2)).astype(np.float32)
    out["degenerate"] = (*_padded(p1[:10], p2[:10]), Kd, False, 2, None, None)
    x1, x2, K, R, t = make_two_view(120, noise=0.2, seed=4)
    out["uncalibrated"] = (*_padded(x1, x2), K, False, 5, R, t)
    x1, x2, K, R, t = make_two_view(150, noise=0.3, seed=6)
    out["calibrated_pose"] = (*_padded(x1, x2), K, True, 7, R, t)
    return out


CASES = _cases()


def port_single(case, uniforms, **kw):
    p1, p2, m, K, cal = CASES[case][:5]
    res = ransac.estimate_two_view(
        torch.from_numpy(p1), torch.from_numpy(p2), torch.from_numpy(m),
        torch.from_numpy(K), torch.from_numpy(K), cal, uniforms, iters=ITERS, **kw)
    return {k: v.numpy() for k, v in res._asdict().items()}


@pytest.fixture(scope="module")
def reference():
    """case -> the JAX estimate as numpy arrays."""
    out = {}
    for name, (p1, p2, m, K, cal, seed, *_) in CASES.items():
        res = jransac.estimate_two_view(p1, p2, m, K, K, np.bool_(cal),
                                        jax.random.key(seed), iters=ITERS)
        out[name] = {k: np.asarray(v) for k, v in res._asdict().items()}
    return out


@pytest.fixture(scope="module")
def injected():
    """case -> the reference's uniforms for that case's key."""
    return {name: jax_uniforms(jax.random.key(c[5])) for name, c in CASES.items()}


def _sign_free(a, b):
    return min(np.abs(a - b).max(), np.abs(a + b).max())


def _rot_deg(Ra, Rb):
    c = (np.trace(Ra.T @ Rb) - 1) / 2
    return float(np.degrees(np.arccos(np.clip(c, -1, 1))))


@pytest.mark.parametrize("case", list(CASES))
def test_estimate_two_view_matches_reference(case, reference, injected):
    """The same samples through both packages: equal configs, inlier counts
    within 2 and at most 2 inlier flags apart (points at the threshold), H
    within 1e-3 of its largest entry, F and E within 1e-2 up to sign and
    rotations within 0.05 deg -- except where the 5-point loop ran
    ("outliers"): there the best of a chunk's hypotheses can change with
    the rounding, and both poses are held to the ground truth instead."""
    ref = reference[case]
    got = port_single(case, injected[case])
    assert int(got["config"]) == int(ref["config"])
    assert abs(int(got["num_inliers"]) - int(ref["num_inliers"])) <= 2
    assert int((got["inlier_mask"] != ref["inlier_mask"]).sum()) <= 2
    assert np.abs(got["H"] - ref["H"]).max() <= 1e-3 * np.abs(ref["H"]).max()
    R_got = tgeom.qvec_to_rotmat(torch.from_numpy(got["qvec"])).numpy()
    R_ref = tgeom.qvec_to_rotmat(torch.from_numpy(np.array(ref["qvec"]))).numpy()
    if case == "outliers":
        R_true = CASES[case][6]
        assert _rot_deg(R_got, R_true) < 1.0 and _rot_deg(R_ref, R_true) < 1.0
    elif case != "degenerate":
        assert _sign_free(got["F"], ref["F"]) <= 1e-2
        assert _sign_free(got["E"], ref["E"]) <= 1e-2
        assert _rot_deg(R_got, R_ref) <= 0.05


def test_reference_bounds_hold(injected):
    """tests/test_geometry.py's own assertions on the port's estimates."""
    out = port_single("outliers", injected["outliers"])
    inl = out["inlier_mask"]
    assert int(out["num_inliers"]) >= 120 and inl[:150].sum() >= 120
    assert inl[150:200].sum() <= 10
    assert int(out["config"]) == TWO_VIEW_CONFIG["CALIBRATED"]
    assert int(port_single("planar", injected["planar"])["config"]) == \
        TWO_VIEW_CONFIG["PLANAR_OR_PANORAMIC"]
    assert int(port_single("degenerate", injected["degenerate"])["config"]) == \
        TWO_VIEW_CONFIG["DEGENERATE"]
    out = port_single("uncalibrated", injected["uncalibrated"])
    assert int(out["config"]) == TWO_VIEW_CONFIG["UNCALIBRATED"]
    assert int(out["num_inliers"]) >= 100
    out = port_single("calibrated_pose", injected["calibrated_pose"])
    _, _, _, _, _, _, R_true, t_true = CASES["calibrated_pose"]
    assert int(out["config"]) == TWO_VIEW_CONFIG["CALIBRATED"]
    R = tgeom.qvec_to_rotmat(torch.from_numpy(out["qvec"])).numpy()
    assert _rot_deg(R, R_true) < 1.0
    assert abs(out["tvec"] @ (t_true / np.linalg.norm(t_true))) > np.cos(np.deg2rad(2.0))


@pytest.mark.parametrize("num_valid,m", [(9, 8), (20, 8), (100, 8), (10, 4), (3, 5),
                                         (0, 8), (256, 5)])
def test_sample_minimal_bit_equal(num_valid, m):
    """The reference's sampler and the port's on the same uniforms: the
    same index sets, bit for bit."""
    key = jax.random.key(num_valid * 10 + m)
    ref = np.asarray(jransac._sample_minimal(key, 64, m, np.int32(num_valid), K_MAX))
    u = torch.from_numpy(np.array(jax.random.uniform(key, (64, m))))
    got = ransac._sample_minimal(u, m, torch.tensor(num_valid), K_MAX).numpy()
    np.testing.assert_array_equal(got, ref)
    if num_valid >= m:
        assert got.max() < num_valid
        assert all(len(set(row.tolist())) == m for row in got)


def test_sample_minimal_uniform():
    u = torch.rand(4000, 4, generator=torch.Generator().manual_seed(3))
    counts = np.bincount(ransac._sample_minimal(u, 4, torch.tensor(10), 64).numpy().ravel(),
                         minlength=10)
    assert counts.min() > 1300 and counts.max() < 1900, counts


def _batch(names, uniforms):
    """The named cases as one batch (a None name is an all-padding lane)."""
    p1, p2, m, K, cal, us = [], [], [], [], [], []
    for name in names:
        c = CASES[name or "degenerate"]
        p1.append(c[0])
        p2.append(c[1])
        m.append(c[2] & (name is not None))
        K.append(c[3])
        cal.append(c[4])
        us.append(uniforms[name or "degenerate"])
    stack = lambda xs: torch.from_numpy(np.stack(xs))  # noqa: E731
    u = ransac.RansacUniforms(*(None if parts[0] is None else torch.stack(parts)
                                for parts in zip(*us)))
    return (stack(p1), stack(p2), stack(m), stack(K), stack(K), stack(cal)), u


def test_lane_semantics(injected):
    """A hard lane (the 5-point loop runs) batched with easy lanes and an
    all-padding lane: each lane's result equals its result alone, and the
    padding lane runs no chunk."""
    names = ["calibrated_pose", "outliers", None, "planar", "uncalibrated"]
    args, u = _batch(names, injected)
    chunks = Counter()
    res = ransac.estimate_two_view_batched(*args, u, iters=ITERS, chunks=chunks)
    for b, name in enumerate(names):
        if name is None:
            assert int(res.num_inliers[b]) == 0
            assert int(res.config[b]) == TWO_VIEW_CONFIG["DEGENERATE"]
            continue
        alone = port_single(name, injected[name])
        for field, value in alone.items():
            np.testing.assert_allclose(getattr(res, field)[b].numpy(), value, atol=1e-6,
                                       err_msg=f"{name} {field}")
    easy, u_easy = _batch([n for n in names if n != "outliers"], injected)
    easy_chunks = Counter()
    ransac.estimate_two_view_batched(*easy, u_easy, iters=ITERS, chunks=easy_chunks)
    assert chunks["e5"] > 0 and easy_chunks["e5"] == 0  # easy lanes skip 5-point
    padding_only, u_pad = _batch([None, None], injected)
    pad_chunks = Counter()
    ransac.estimate_two_view_batched(*padding_only, u_pad, iters=ITERS, chunks=pad_chunks)
    assert sum(pad_chunks.values()) == 0


def test_packed_equals_unpacked(injected):
    """Flat valid-only buffers scattered into the padded layout: the same
    results bit for bit, padding lane included."""
    names = ["outliers", "uncalibrated", None, "planar"]
    (p1, p2, m, K1, K2, cal), u = _batch(names, injected)
    ref = ransac.estimate_two_view_batched(p1, p2, m, K1, K2, cal, u, iters=ITERS)
    flat1, flat2, dest = [], [], []
    for b in range(len(names)):
        n = int(m[b].sum())
        flat1.append(p1[b, :n])
        flat2.append(p2[b, :n])
        dest.append(b * K_MAX + torch.arange(n))
    pad = 37
    flat1 = torch.cat(flat1 + [torch.full((pad, 2), 5.0)])
    flat2 = torch.cat(flat2 + [torch.full((pad, 2), 7.0)])
    dest = torch.cat(dest + [torch.full((pad,), len(names) * K_MAX)]).int()
    got = ransac.estimate_two_view_batched_packed(
        flat1, flat2, dest, K1, K2, cal, u, n_pairs=len(names), k_max=K_MAX, iters=ITERS)
    for field in ref._fields:
        assert torch.equal(getattr(got, field), getattr(ref, field)), field


def test_global_tf32_flag_does_not_reach_the_fits(injected, monkeypatch):
    """With ``allow_tf32`` set globally the fits run with it off, give the
    same results, and the caller's setting is back afterwards."""
    seen = []
    fit = tgeom.fit_fundamental

    def spy(*a, **k):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return fit(*a, **k)

    monkeypatch.setattr(tgeom, "fit_fundamental", spy)
    off = port_single("calibrated_pose", injected["calibrated_pose"])
    previous = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        on = port_single("calibrated_pose", injected["calibrated_pose"])
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = previous
    assert seen and not any(seen)
    for field, value in off.items():
        np.testing.assert_array_equal(on[field], value)


def test_draw_uniforms_layout():
    """One draw per batch: the stream shapes of the plan, and the same
    generator seed gives the same uniforms."""
    kw = dict(iters=1024, five_point=True, five_point_chunk=16)
    a = ransac.draw_uniforms(3, torch.Generator().manual_seed(1), **kw)
    b = ransac.draw_uniforms(3, torch.Generator().manual_seed(1), **kw)
    assert a.f.shape == (3, 8, 128, 8) and a.h.shape == (3, 2, 128, 4)
    assert a.e.shape == (3, 8, 128, 8) and a.e5.shape == (3, 64, 16, 5)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert ransac.draw_uniforms(3, iters=1024, five_point=False).e5 is None
    with pytest.raises(ValueError, match="another essential solver"):
        port_single("planar", ransac.draw_uniforms(1, iters=ITERS, five_point=False))
