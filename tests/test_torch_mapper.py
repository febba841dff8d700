"""The port's incremental mapper (``sfm/incremental.py``) against the JAX
package's, and stage 3 of the port's ``Pipeline.run``.

The scene is ``tests/test_sfm.py``'s: 150 points seen by 5 cameras on an
arc, 0.3 px noise, every pair verified with identity matches.  The JAX
mapper runs once (module fixture); the port runs on the CPU with the
reference's PnP uniforms injected (``jax.random.key(0)``, one ``split`` per
registration attempt, ``uniform(k, (512, 6))``).  Bounds: the same init
pair and registration order, all 5 images registered by both, point counts
within 2%, mean reprojection errors within 0.05 px, every rotation within
0.05 degrees of the reference's (both fix the first image at the identity;
the angle is taken from the quaternions in float64, since the f32 rotation
matrices' trace cannot resolve less than about 0.02 degrees) and every
camera centre within 1e-3 of the scene's extent after the gauge alignment
of ``sfm/align.pose_errors_vs_gt``.  f32 rounding in another order moves
BA's optimum by far less; the bounds leave room for a triangulated point
more or less at a threshold.
"""

import logging

import jax
import numpy as np
import pytest
import torch

from tests.test_sfm import _look_at_scene, _project
from vit_colmap_tpu.sfm.incremental import incremental_mapping as jax_mapping
from vit_colmap_tpu.utils.config import ReconstructionConfig as JaxReconstructionConfig
from vit_colmap_tpu_torch.database import ColmapDatabase
from vit_colmap_tpu_torch.pipeline import Pipeline
from vit_colmap_tpu_torch.sfm.align import pose_errors_vs_gt
from vit_colmap_tpu_torch.sfm.incremental import (
    IncrementalMapper,
    _MapperState,
    incremental_mapping,
)
from vit_colmap_tpu_torch.sfm.reconstruction import read_text
from vit_colmap_tpu_torch.utils.config import Config, ReconstructionConfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def write_scene_db(db_path, n_pts=150, n_cams=5, seed=3, descriptors=False):
    """``tests/test_sfm.py``'s mapper scene as a COLMAP database.  With
    ``descriptors`` it holds features only (one random descriptor per 3D
    point, the same in every view) for the pipeline to match and verify;
    otherwise also the identity matches as verified geometries."""
    X, K, cams = _look_at_scene(n_pts=n_pts, n_cams=n_cams, seed=seed)
    rng = np.random.default_rng(4)
    desc = rng.integers(0, 255, (n_pts, 128), dtype=np.uint8)
    db = ColmapDatabase(db_path)
    cid = db.add_pinhole_camera(640, 480, K[0, 0], K[1, 1], K[0, 2], K[1, 2])
    ids = []
    for i, (R, t) in enumerate(cams):
        uv, _ = _project(R, t, K, X)
        uv = uv + 0.3 * rng.standard_normal(uv.shape)
        iid = db.add_image(f"cam{i}.png", cid)
        db.add_keypoints(iid, uv.astype(np.float32))
        db.add_descriptors(iid, desc)
        ids.append(iid)
    if not descriptors:
        m = np.stack([np.arange(n_pts)] * 2, axis=1).astype(np.uint32)
        for a in range(len(ids)):
            for b in range(a + 1, len(ids)):
                db.add_matches(ids[a], ids[b], m)
                db.add_two_view_geometry(ids[a], ids[b], m, config=2)
    db.commit()
    db.close()
    return {f"cam{i}.png": c for i, c in enumerate(cams)}


def rotation_between_deg(q1, q2) -> float:
    """Angle of the rotation between two unit quaternions (w, x, y, z),
    in float64."""
    q1, q2 = (np.asarray(q, np.float64) / np.linalg.norm(q) for q in (q1, q2))
    w = abs(float(q1 @ q2))
    v = np.linalg.norm(q1[0] * q2[1:] - q2[0] * q1[1:] - np.cross(q1[1:], q2[1:]))
    return float(np.degrees(2.0 * np.arctan2(v, w)))


def jax_pnp_sampler():
    """The reference's PnP uniforms: key(0), one split per attempt."""
    state = {"key": jax.random.key(0)}

    def draw(iters):
        state["key"], k = jax.random.split(state["key"])
        return torch.tensor(np.asarray(jax.random.uniform(k, (iters, 6))))

    return draw


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mapper")
    gt = write_scene_db(tmp / "db.db")
    ref = jax_mapping(tmp / "db.db", tmp, tmp / "jax_sparse",
                      JaxReconstructionConfig(min_num_matches=15))
    return tmp, gt, ref


def test_mapper_matches_jax(scene, caplog):
    tmp, gt, ref = scene
    log = {}
    with caplog.at_level(logging.INFO, logger="vit_colmap_tpu_torch.sfm.incremental"):
        ours = incremental_mapping(tmp / "db.db", tmp, tmp / "sparse",
                                   ReconstructionConfig(min_num_matches=15), device="cpu",
                                   pnp_sampler_factory=jax_pnp_sampler, log=log)
    assert len(ours) == len(ref) == 1
    r, j = ours[0], ref[0]
    # Insertion order of the images: the init pair, then each registration.
    assert list(r.images) == list(j.images) and len(r.images) == 5
    assert abs(len(r.points3D) - len(j.points3D)) <= 0.02 * len(j.points3D)
    assert len(r.points3D) >= 100
    assert abs(r.mean_reprojection_error() - j.mean_reprojection_error()) < 0.05
    for iid, im in r.images.items():
        assert rotation_between_deg(im.qvec, j.images[iid].qvec) < 0.05
    ref_poses = {im.name: (im.R(), im.tvec) for im in j.images.values()}
    vs_ref = pose_errors_vs_gt(r, ref_poses)
    assert vs_ref["pose_center_err_rel_max"] < 1e-3, vs_ref
    assert pose_errors_vs_gt(r, gt)["pose_rot_err_deg_max"] < 0.5
    # The substep and BA logs.
    assert "Mapper substep seconds" in caplog.text and "host syncs" in caplog.text
    ba = log[0]["ba"]
    assert ba["calls"] > 0 and ba["lm_iters"] >= ba["calls"]
    assert ba["syncs"] == ba["lm_iters"] + ba["calls"]
    # Written in COLMAP text and binary form; the text reads back.
    loaded = read_text(tmp / "sparse" / "0")
    assert len(loaded.images) == 5 and len(loaded.points3D) == len(r.points3D)
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        assert (tmp / "sparse" / "0" / name).exists()


def test_mapper_defaults_to_cuda(scene, monkeypatch):
    tmp, _, _ = scene
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        incremental_mapping(tmp / "db.db", tmp, tmp / "never")


def _merge_fixture(n_pts, seed, rows):
    X, K, cams = _look_at_scene(n_pts=n_pts, n_cams=4, seed=seed)
    cameras = {1: {"camera_id": 1, "model": "PINHOLE", "width": 640, "height": 480,
                   "params": np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]]),
                   "prior_focal_length": True}}
    images = {i + 1: {"image_id": i + 1, "name": f"i{i}", "camera_id": 1} for i in range(4)}
    kps = {i + 1: np.vstack(rows(_project(R, t, K, X)[0])).astype(np.float32)
           for i, (R, t) in enumerate(cams)}
    state = _MapperState(cameras, images, kps)
    mapper = IncrementalMapper(state, {}, ReconstructionConfig(), device="cpu")
    for i, (R, t) in enumerate(cams):
        state.poses[i + 1] = (R, t)
    return X, state, mapper


def test_track_merge():
    """``tests/test_sfm.py``'s MergeTracks case: consistent duplicates
    merge; an inconsistent or same-image merge is refused."""
    X, state, mapper = _merge_fixture(1, 9, lambda uv: [uv, uv + 500.0])
    xyz = X[0]
    pa = state.add_point(xyz + 0.001, [(1, 0), (2, 0)])
    pb = state.add_point(xyz - 0.001, [(3, 0), (4, 0)])
    assert mapper.try_merge(pa, pb)
    assert pb not in state.points
    assert len(state.tracks[pa]) == 4
    assert all(state.feat_pid[i][0] == pa for i in (1, 2, 3, 4))
    pc = state.add_point(xyz, [(1, 1)])
    pd = state.add_point(xyz + np.array([5.0, 5.0, 0.0]), [(3, 1)])
    assert not mapper.try_merge(pc, pd)
    assert pd in state.points
    pe = state.add_point(xyz, [(2, 1)])
    assert not mapper.try_merge(pa, pe)
    assert (2, 1) not in state.tracks[pa]


def test_track_merge_batch():
    """``tests/test_sfm.py``'s batched case: disjoint candidates evaluate
    together, pid-sharing ones chain, inconsistent ones are refused."""
    X, state, mapper = _merge_fixture(3, 11, lambda uv: [uv, uv[:1] + 500.0, uv[:1]])
    pa = state.add_point(X[0] + 0.001, [(1, 0), (2, 0)])
    pb = state.add_point(X[0] - 0.001, [(3, 0)])
    pc = state.add_point(X[1], [(1, 1), (2, 1)])
    pd = state.add_point(X[1] + 0.001, [(3, 1), (4, 1)])
    pe = state.add_point(X[2], [(1, 2)])
    pf = state.add_point(X[2] + np.array([5.0, 5.0, 0.0]), [(3, 2)])
    pg = state.add_point(X[0] + 0.002, [(4, 4)])  # chains onto pa after its merge
    n = mapper.try_merge_batch([(pa, pb), (pc, pd), (pe, pf), (pa, pg)])
    assert n == 3, n
    assert pb not in state.points and pd not in state.points
    assert len(state.tracks[pa]) == 4
    assert pg not in state.points
    assert pf in state.points
    assert all(state.feat_pid[i][0] == pa for i in (1, 2, 3))
    assert state.feat_pid[4][4] == pa


class SceneExtractor:
    """Writes the mapper scene's features into the pipeline's database, as
    an extractor would: matching and verification then run on them."""

    def extract(self, image_dir, db_path, camera_model, camera_params=None):
        write_scene_db(db_path, descriptors=True)


def test_pipeline_run_reconstructs_by_default(tmp_path, monkeypatch):
    cfg = Config()
    assert cfg.do_reconstruction
    pipe = Pipeline(cfg, device="cpu")
    monkeypatch.setattr(pipe, "_make_extractor", lambda: SceneExtractor())
    report = pipe.run(tmp_path / "images", tmp_path / "out", tmp_path / "d.db",
                      dataset="synthetic", scene="arc", results_dir=tmp_path / "metrics")
    assert report["registered_images"] == 5 and report["points3d"] >= 100
    assert report["reconstruction_s"] > 0
    sparse = tmp_path / "out" / "sparse" / "0"
    assert len(read_text(sparse).images) == 5
    assert all((sparse / f"{n}.bin").exists() for n in ("cameras", "images", "points3D"))
    import json

    data = json.loads((tmp_path / "metrics" / "synthetic" / "arc" / "vit.json").read_text())
    assert data["reconstruction"]["registered_images"] == 5


def test_pipeline_cli_reconstructs_without_skip_flag(tmp_path, monkeypatch):
    from vit_colmap_tpu_torch.pipeline import run_pipeline

    monkeypatch.setattr(run_pipeline.Pipeline, "_make_extractor",
                        lambda self: SceneExtractor())
    run_pipeline.main(["--images", str(tmp_path / "images"), "--output",
                       str(tmp_path / "out"), "--db", str(tmp_path / "d.db"),
                       "--device", "cpu"])
    assert len(read_text(tmp_path / "out" / "sparse" / "0").images) == 5
