"""``match_exhaustive`` with geometric verification, the port's against
the JAX package's, on one synthetic database of a clean projected scene:
every correspondence of a verified pair is an exact inlier, so the random
samples cannot change the outcome, and the two packages' RANSAC streams
(JAX keys there, a seeded torch generator here) need not agree.

The JAX package runs the 8-point essential solver (one small compile); the
port runs its default, the 5-point solver, whose loop an 8-point seed at
inlier ratio 1 skips: both refit E on the same inlier set.

Bounds: identical ``two_view_geometries`` rows for pair ids, inlier
matches and configs; on the pairs of the 3D scene F and E within 1e-3 up to
sign, qvec and tvec within 1e-3; on the pair of the planar scene, where H
wins, H within 1e-3 of its largest entry.  (H of a 3D scene fits a subset
of the points, which the samples choose; F, E and the pose of a plane are
not unique.)
"""

import shutil
import sqlite3

import numpy as np
import pytest
import torch

from vit_colmap_tpu.pipeline.match import match_exhaustive as jax_match_exhaustive
from vit_colmap_tpu.utils.config import MatchingConfig as JaxMatchingConfig
from vit_colmap_tpu_torch.database import TWO_VIEW_CONFIG, ColmapDatabase
from vit_colmap_tpu_torch.pipeline.match import batch_generator, match_exhaustive
from vit_colmap_tpu_torch.utils.config import MatchingConfig

W, H, F = 640, 480, 500.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This file's many small tensor operations on one intra-op thread: six
    test workers share the machine's cores, and their threads' spinning
    otherwise slows such operations many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rotation(rng, scale):
    aa = rng.standard_normal(3) * scale
    th = np.linalg.norm(aa)
    k = aa / th
    S = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * S + (1 - np.cos(th)) * S @ S


def _project(X, R, t):
    K = np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1]])
    x = (X @ R.T + t) @ K.T
    return x[:, :2] / x[:, 2:]


def make_scene_db(path, seed=0, n_points=200):
    """Four views of one rigid 3D scene (three share a camera with a prior
    focal length, the fourth's camera has none), two views of a plane, a
    view that shares 12 points with the 3D scene (verified, below
    min_num_inliers) and one that shares 6 (too few to verify).  Each view
    lists its keypoints in its own order; a point's descriptor is the same
    in every view."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-1.5, 1.5, n_points), rng.uniform(-1, 1, n_points),
                  rng.uniform(4, 8, n_points)], axis=1)
    desc = rng.integers(0, 256, (n_points, 128), dtype=np.uint8)
    db = ColmapDatabase(path)
    cam_prior = db.add_camera("SIMPLE_PINHOLE", W, H, [F, W / 2, H / 2],
                              prior_focal_length=True)
    cam_none = db.add_camera("SIMPLE_PINHOLE", W, H, [F, W / 2, H / 2])
    views = []
    for v in range(4):
        R = _rotation(rng, 0.05)
        t = np.array([0.4 * v, 0.05 * rng.standard_normal(), 0.0])
        views.append(_project(X, R, t))
    inside = np.all([(p[:, 0] > 0) & (p[:, 0] < W) & (p[:, 1] > 0) & (p[:, 1] < H)
                     for p in views], axis=0)
    for v, pts in enumerate(views):
        perm = rng.permutation(np.nonzero(inside)[0])
        iid = db.add_image(f"view_{v}.png", cam_prior if v < 3 else cam_none)
        db.add_keypoints(iid, pts[perm].astype(np.float32))
        db.add_descriptors(iid, desc[perm])
    for v, shared in ((4, 12), (5, 6)):
        keep = np.nonzero(inside)[0][:shared]
        pts = np.concatenate([views[0][keep], rng.uniform([0, 0], [W, H], (100, 2))])
        d = np.concatenate([desc[keep], rng.integers(0, 256, (100, 128), dtype=np.uint8)])
        iid = db.add_image(f"view_{v}.png", cam_prior)
        db.add_keypoints(iid, pts.astype(np.float32))
        db.add_descriptors(iid, d)
    plane = np.stack([rng.uniform(-1, 1, 150), rng.uniform(-0.8, 0.8, 150)], axis=1)
    plane = np.concatenate([plane, 5.0 + 0.3 * plane[:, :1]], axis=1)
    plane_desc = rng.integers(0, 256, (150, 128), dtype=np.uint8)
    for v in (6, 7):
        pts = _project(plane, _rotation(rng, 0.05), np.array([0.3 * (v - 6), 0.0, 0.0]))
        iid = db.add_image(f"view_{v}.png", cam_prior)
        db.add_keypoints(iid, pts.astype(np.float32))
        db.add_descriptors(iid, plane_desc)
    db.commit()
    db.close()
    return int(inside.sum())


def _rows(db_path, table):
    con = sqlite3.connect(db_path)
    try:
        return con.execute(f"SELECT * FROM {table} ORDER BY pair_id").fetchall()
    finally:
        con.close()


def _geometries(db_path):
    with ColmapDatabase.open_database(db_path) as db:
        return {pair: db.read_two_view_geometry(*pair)
                for pair in db.read_all_two_view_geometries()}


@pytest.fixture(scope="module")
def verified(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("verify")
    n_inside = make_scene_db(tmp / "scene.db")
    shutil.copy(tmp / "scene.db", tmp / "jax.db")
    shutil.copy(tmp / "scene.db", tmp / "torch.db")
    jstats = jax_match_exhaustive(tmp / "jax.db", JaxMatchingConfig(essential_solver="8pt"))
    tstats = match_exhaustive(tmp / "torch.db", MatchingConfig(), device="cpu")
    return tmp, n_inside, jstats, tstats


def test_matches_identical(verified):
    tmp, *_ = verified
    assert _rows(tmp / "torch.db", "matches") == _rows(tmp / "jax.db", "matches")


def test_two_view_geometries_match_jax(verified):
    tmp, n_inside, jstats, tstats = verified
    ref, got = _geometries(tmp / "jax.db"), _geometries(tmp / "torch.db")
    # The 6 pairs of the 3D scene's views and the plane's pair; the 12-point
    # pairs verify to DEGENERATE and the 6-point pairs are not verified:
    # neither is written.
    assert sorted(got) == sorted(ref) and len(ref) == 7
    for pair, g in got.items():
        r = ref[pair]
        assert g["config"] == r["config"]
        np.testing.assert_array_equal(g["inlier_matches"], r["inlier_matches"])
        if g["config"] == TWO_VIEW_CONFIG["PLANAR_OR_PANORAMIC"]:
            assert len(g["inlier_matches"]) == 150
            assert np.abs(g["H"] - r["H"]).max() <= 1e-3 * np.abs(r["H"]).max()
            continue
        assert len(g["inlier_matches"]) == n_inside
        for key in ("F", "E"):
            assert min(np.abs(g[key] - r[key]).max(), np.abs(g[key] + r[key]).max()) <= 1e-3
        np.testing.assert_allclose(g["qvec"], r["qvec"], atol=1e-3)
        np.testing.assert_allclose(g["tvec"], r["tvec"], atol=1e-3)
    configs = sorted(g["config"] for g in got.values())
    assert configs == sorted([TWO_VIEW_CONFIG["CALIBRATED"]] * 3
                             + [TWO_VIEW_CONFIG["UNCALIBRATED"]] * 3
                             + [TWO_VIEW_CONFIG["PLANAR_OR_PANORAMIC"]])
    assert (tstats.verified_pairs, tstats.total_inliers) == (
        jstats.verified_pairs, jstats.total_inliers)
    assert tstats.verify_chunks["f"] > 0


def test_verification_is_seeded(verified, tmp_path):
    """The same seed writes the same rows; the batch generators differ by
    seed and by batch start."""
    tmp, *_ = verified
    shutil.copy(tmp / "scene.db", tmp_path / "again.db")
    match_exhaustive(tmp_path / "again.db", MatchingConfig(), device="cpu")
    assert _rows(tmp_path / "again.db", "two_view_geometries") == \
        _rows(tmp / "torch.db", "two_view_geometries")
    draws = [torch.rand(4, generator=batch_generator(s, start))
             for s, start in ((0, 0), (1, 0), (0, 64))]
    assert not torch.equal(draws[0], draws[1]) and not torch.equal(draws[0], draws[2])
    assert torch.equal(draws[0], torch.rand(4, generator=batch_generator(0, 0)))


def test_eight_point_solver_and_small_batches(verified, tmp_path):
    """``essential_solver="8pt"`` and batches of 2 pairs write the same
    inlier sets and configs."""
    tmp, *_ = verified
    shutil.copy(tmp / "scene.db", tmp_path / "b.db")
    stats = match_exhaustive(tmp_path / "b.db", MatchingConfig(
        essential_solver="8pt", verify_pair_batch=2), device="cpu")
    assert "e5" not in stats.verify_chunks
    ref, got = _geometries(tmp / "torch.db"), _geometries(tmp_path / "b.db")
    assert sorted(got) == sorted(ref)
    for pair in got:
        assert got[pair]["config"] == ref[pair]["config"]
        np.testing.assert_array_equal(got[pair]["inlier_matches"],
                                      ref[pair]["inlier_matches"])


def test_skip_verification_writes_no_geometries(tmp_path):
    make_scene_db(tmp_path / "s.db")
    stats = match_exhaustive(tmp_path / "s.db", MatchingConfig(do_verification=False),
                             device="cpu")
    assert stats.matched_pairs > 0 and stats.verified_pairs == 0
    assert _rows(tmp_path / "s.db", "two_view_geometries") == []
