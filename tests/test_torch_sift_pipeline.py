"""``Pipeline.run(extractor_type="sift")`` of the port against the JAX
package's, on 4 views of the rendered multi-view scene (the JAX package's
OpenCV renderer, 192 x 256, the ``scripts/bench_reconstruction.py``
protocol's seed and focal rule), on the CPU, with a PINHOLE camera at the
renderer's K, 512 keypoints and verification on.

Bounds: the same images and cameras; per image the same keypoint count,
and for 99% of the JAX package's keypoints one of the port's within 2e-3
px and scale and 5e-3 rad (keypoints of nearly equal score may swap ranks,
as the two blurs round differently), their descriptor bytes within 1 level
for 99% (all within 16); matches: the same
pairs, each pair's match rows equal for at least 97% of them; verification
(the packages draw different RANSAC samples): the same verified pairs with
the same configurations, inlier counts within 10%.  Then the port
reconstructs the 4 views, held to the renderer's poses: all 4 registered,
rotation error under 0.5 deg.
"""

import json
import sqlite3

import numpy as np
import pytest
import torch

from vit_colmap_tpu.dataloader.synthetic_benchmark import render_multiview_scene
from vit_colmap_tpu.pipeline import Pipeline as JaxPipeline
from vit_colmap_tpu.utils.config import Config as JaxConfig
from vit_colmap_tpu_torch.database import ColmapDatabase
from vit_colmap_tpu_torch.pipeline import Pipeline
from vit_colmap_tpu_torch.sfm.align import best_pose_errors, gt_poses_for_rendered_scene
from vit_colmap_tpu_torch.utils.config import Config

SIZE = (192, 256)
FOCAL = 0.94 * max(SIZE)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("sift_pipeline")
    image_dir = work / "images"
    _, K = render_multiview_scene(image_dir, n_cams=4, size=SIZE, focal=FOCAL, seed=7)
    params = [K[0, 0], K[1, 1], K[0, 2], K[1, 2]]
    dbs, pipes = {}, {}
    for name, pipe_cls, cfg_cls, kw in (("jax", JaxPipeline, JaxConfig, {}),
                                        ("torch", Pipeline, Config, {"device": "cpu"})):
        cfg = cfg_cls()
        cfg.extractor.extractor_type = "sift"
        cfg.extractor.max_keypoints = 512
        cfg.camera.model = "PINHOLE"
        cfg.camera.params = [float(p) for p in params]
        cfg.do_reconstruction = name == "torch"
        pipes[name] = pipe_cls(cfg, **kw)
        dbs[name] = work / f"{name}.db"
        pipes[name].run(image_dir, work / f"{name}_out", dbs[name])
    return image_dir, dbs, pipes


def _rows(db_path, sql):
    con = sqlite3.connect(db_path)
    try:
        return con.execute(sql).fetchall()
    finally:
        con.close()


def pair_keypoints(ka, kb, tol=2e-3, ang_tol=5e-3):
    """Rows (ia, ib) where a keypoint of ``kb`` lies within ``tol`` px (and
    scale) of one of ``ka`` with an orientation within ``ang_tol`` rad;
    keypoints of nearly equal score may swap ranks between the packages."""
    near = np.abs(kb[:, None, :3] - ka[None, :, :3]).max(-1) <= tol
    ang = np.abs(np.angle(np.exp(1j * (kb[:, None, 3].astype(np.float64)
                                       - ka[None, :, 3]))))
    ok = near & (ang <= ang_tol)
    ib = np.nonzero(ok.any(1))[0]
    return np.argmax(ok[ib], axis=1), ib


def test_database_rows_match_jax(runs):
    _, dbs, _ = runs
    for sql in ("SELECT * FROM cameras ORDER BY 1", "SELECT * FROM images ORDER BY 1"):
        assert _rows(dbs["torch"], sql) == _rows(dbs["jax"], sql)
    with ColmapDatabase.open_database(dbs["jax"]) as a, \
            ColmapDatabase.open_database(dbs["torch"]) as b:
        for i in sorted(a.read_images()):
            ka, kb = a.read_keypoints(i), b.read_keypoints(i)
            assert ka.shape == kb.shape and ka.shape[1] == 4 and len(ka) > 100
            da, db_ = a.read_descriptors(i), b.read_descriptors(i)
            assert db_.dtype == np.uint8 and db_.shape == da.shape
            ia, ib = pair_keypoints(ka, kb)
            assert len(ia) >= 0.99 * len(ka), (len(ia), len(ka))
            diff = np.abs(da[ia].astype(int) - db_[ib].astype(int))
            assert (diff <= 1).mean() >= 0.99 and diff.max() <= 16


def test_matches_match_jax(runs):
    _, dbs, _ = runs
    with ColmapDatabase.open_database(dbs["jax"]) as a, \
            ColmapDatabase.open_database(dbs["torch"]) as b:
        ma, mb = a.read_all_matches(), b.read_all_matches()
        assert ma.keys() == mb.keys() and len(ma) == 6
        for pair, m in ma.items():
            ra = {tuple(r) for r in m.tolist()}
            rb = {tuple(r) for r in mb[pair].tolist()}
            assert len(ra & rb) >= 0.97 * max(len(ra), len(rb)), pair


def test_verified_pairs_match_jax(runs):
    _, dbs, _ = runs
    with ColmapDatabase.open_database(dbs["jax"]) as a, \
            ColmapDatabase.open_database(dbs["torch"]) as b:
        ga, gb = a.read_all_two_view_geometries(), b.read_all_two_view_geometries()
        verified = {k for k, g in ga.items() if len(g["inlier_matches"]) > 0}
        assert verified and verified == {k for k, g in gb.items()
                                         if len(g["inlier_matches"]) > 0}
        for k in verified:
            assert ga[k]["config"] == gb[k]["config"], k
            na, nb = len(ga[k]["inlier_matches"]), len(gb[k]["inlier_matches"])
            assert abs(na - nb) <= 0.1 * na, (k, na, nb)


def test_port_reconstructs_the_rendered_views(runs):
    image_dir, _, pipes = runs
    recs = pipes["torch"].reconstructions
    assert sum(len(r.images) for r in recs.values()) == 4
    pose = best_pose_errors(recs, gt_poses_for_rendered_scene(image_dir))
    assert pose["aligned_cameras"] == 4 and pose["pose_rot_err_deg_max"] < 0.5, pose
    assert json.loads((image_dir / "gt_poses.json").read_text()).keys() == {
        f"view_{i:03d}.png" for i in range(4)}
