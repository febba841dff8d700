"""The port's metrics extraction and export against the JAX package's
``MetricsExtractor`` and exporter on the same database: equal feature and
matching metrics, and the same JSON and ``summary.csv`` (timestamps
aside); the counterpart of ``tests/test_metrics_export.py``."""

import csv
import dataclasses
import json

import numpy as np
import pytest

from vit_colmap_tpu.utils.export import export_metrics as jax_export_metrics
from vit_colmap_tpu.utils.metrics import MetricsExtractor as JaxMetricsExtractor
from vit_colmap_tpu_torch.database import ColmapDatabase
from vit_colmap_tpu_torch.utils.export import MetricsExporter, export_metrics
from vit_colmap_tpu_torch.utils.metrics import MetricsExtractor, MetricsResult


@pytest.fixture
def populated_db(tmp_path):
    db = ColmapDatabase(tmp_path / "m.db")
    cid = db.add_pinhole_camera(100, 100, 90, 90, 50, 50)
    ids = [db.add_image(f"i{i}", cid) for i in range(4)]
    rng = np.random.default_rng(0)
    for n, iid in zip((10, 20, 30, 40), ids):
        db.add_keypoints(iid, rng.random((n, 2)).astype(np.float32))
        db.add_descriptors(iid, rng.integers(0, 255, (n, 128), dtype=np.uint8))
    m = np.stack([np.arange(8, dtype=np.uint32)] * 2, 1)
    db.add_matches(ids[0], ids[1], m)
    db.add_matches(ids[1], ids[2], m[:5])
    db.add_matches(ids[2], ids[3], m[:7])
    db.add_two_view_geometry(ids[0], ids[1], m[:6], config=2)
    db.add_two_view_geometry(ids[2], ids[3], m[:7], config=6)
    db.commit()
    db.close()
    return tmp_path / "m.db"


@pytest.mark.parametrize("threshold", [None, 6, 7])
def test_feature_and_matching_metrics_match_jax(populated_db, tmp_path, threshold):
    ours = MetricsExtractor(populated_db, tmp_path)
    ref = JaxMetricsExtractor(populated_db, tmp_path)
    assert dataclasses.asdict(ours.extract_feature_metrics()) == \
        dataclasses.asdict(ref.extract_feature_metrics())
    m = ours.extract_matching_metrics(threshold)
    assert dataclasses.asdict(m) == dataclasses.asdict(ref.extract_matching_metrics(threshold))
    assert m.total_image_pairs == 6 and m.matched_pairs == 3 and m.verified_pairs == 2
    assert m.total_raw_matches == 20 and m.total_inlier_matches == 13
    assert m.inlier_ratio == pytest.approx(13 / 20)
    assert m.config_distribution == {"CALIBRATED": 1, "PLANAR_OR_PANORAMIC": 1}


def test_export_matches_jax_and_round_trips(populated_db, tmp_path):
    ours = MetricsExtractor(populated_db, tmp_path).extract_all_metrics(
        "DS", "scene1", "vit", config={"a": 1})
    ref = JaxMetricsExtractor(populated_db, tmp_path).extract_all_metrics(
        "DS", "scene1", "vit", config={"a": 1})
    assert ours.reconstruction is None
    path = export_metrics(ours, tmp_path / "torch")
    ref_path = jax_export_metrics(ref, tmp_path / "jax")
    assert path == tmp_path / "torch" / "DS" / "scene1" / "vit.json"
    got, want = json.loads(path.read_text()), json.loads(ref_path.read_text())
    got.pop("timestamp"), want.pop("timestamp")
    assert got == want

    def csv_rows(base):
        with open(base / "summary.csv") as f:
            return [{k: v for k, v in row.items() if k != "timestamp"}
                    for row in csv.DictReader(f)]

    assert csv_rows(tmp_path / "torch") == csv_rows(tmp_path / "jax")
    loaded = MetricsExporter(tmp_path / "torch").load_metrics("DS", "scene1", "vit")
    assert isinstance(loaded, MetricsResult)
    assert loaded.features.total_keypoints == 100 and loaded.config == {"a": 1}
    export_metrics(ours, tmp_path / "torch")  # the CSV gets a second row
    lines = (tmp_path / "torch" / "summary.csv").read_text().strip().splitlines()
    assert len(lines) == 3
    assert len(MetricsExporter(tmp_path / "torch").load_all_metrics()) == 1


def test_reconstruction_metrics_of_duck_typed_models(populated_db, tmp_path):
    """Reconstruction metrics read ``.images`` and ``.points3D`` (with
    ``.track`` and ``.error``), as the reference's do."""

    class Point:
        def __init__(self, track, error):
            self.track, self.error = track, error

    class Recon:
        images = {1: None, 2: None, 3: None}
        points3D = {0: Point([1, 2], 0.5), 1: Point([1, 2, 3], 1.5)}

    ours = MetricsExtractor(populated_db, tmp_path).extract_reconstruction_metrics({0: Recon()})
    ref = JaxMetricsExtractor(populated_db, tmp_path).extract_reconstruction_metrics(
        {0: Recon()})
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.registration_rate == pytest.approx(75.0)
    assert MetricsExtractor(populated_db, tmp_path).extract_reconstruction_metrics(None) is None
