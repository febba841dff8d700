"""Multiple models in the port's mapper: two disconnected clusters of views
give two models with disjoint images (``multiple_models=True``), and one
model with ``multiple_models=False``.  The port of
``tests/test_multi_model.py``, at its sizes: 3 cameras and 120 points a
cluster, 0.3 px of noise, BA 10 local and 15 global iterations, on the CPU.
"""

import numpy as np
import pytest
import torch

from vit_colmap_tpu_torch.database import ColmapDatabase
from vit_colmap_tpu_torch.sfm.incremental import incremental_mapping
from vit_colmap_tpu_torch.utils.config import ReconstructionConfig


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _add_cluster(db, cid, rng, n_cams, n_pts, label):
    X = np.concatenate(
        [rng.uniform(-1, 1, (n_pts, 2)), rng.uniform(4, 6, (n_pts, 1))], axis=1
    )
    ids = []
    for i in range(n_cams):
        ang = (i - n_cams / 2) * 0.1
        R = np.array(
            [[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
             [-np.sin(ang), 0, np.cos(ang)]]
        )
        C = np.array([1.5 * np.sin(ang), 0.05 * i, 5 - 5 * np.cos(ang)])
        t = -R @ C
        Xc = X @ R.T + t
        uv = (Xc[:, :2] / Xc[:, 2:]) * 500 + np.array([320, 240])
        uv += 0.3 * rng.standard_normal(uv.shape)
        iid = db.add_image(f"{label}_{i}.png", cid)
        db.add_keypoints(iid, uv.astype(np.float32))
        ids.append(iid)
    m = np.stack([np.arange(n_pts, dtype=np.uint32)] * 2, 1)
    for a in range(n_cams):
        for b in range(a + 1, n_cams):
            db.add_matches(ids[a], ids[b], m)
            db.add_two_view_geometry(ids[a], ids[b], m, config=2)
    return ids


@pytest.fixture(scope="module")
def two_clusters(tmp_path_factory):
    root = tmp_path_factory.mktemp("multi")
    rng = np.random.default_rng(0)
    db = ColmapDatabase(root / "db.db")
    cid = db.add_pinhole_camera(640, 480, 500, 500, 320, 240)
    _add_cluster(db, cid, rng, n_cams=3, n_pts=120, label="a")
    _add_cluster(db, cid, rng, n_cams=3, n_pts=120, label="b")
    db.commit()
    db.close()
    return root


def _map(root, out, multiple_models):
    return incremental_mapping(
        root / "db.db", root, root / out,
        ReconstructionConfig(multiple_models=multiple_models, ba_local_iters=10,
                             ba_global_iters=15),
        device="cpu",
    )


def test_two_disconnected_clusters_give_two_models(two_clusters):
    recs = _map(two_clusters, "sparse", True)
    assert len(recs) == 2
    for rec in recs.values():
        assert len(rec.images) == 3
        assert len(rec.points3D) >= 80
    names = [{im.name for im in rec.images.values()} for rec in recs.values()]
    assert not names[0] & names[1]
    assert {n[0] for n in names[0]} != {n[0] for n in names[1]}  # one cluster each
    assert all((two_clusters / "sparse" / str(k)).is_dir() for k in recs)


def test_single_model_stops_after_one(two_clusters):
    recs = _map(two_clusters, "sparse_single", False)
    assert len(recs) == 1
    (rec,) = recs.values()
    assert len(rec.images) == 3
    assert len({im.name[0] for im in rec.images.values()}) == 1
