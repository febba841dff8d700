"""End-to-end smoke test of the port: the counterpart of
``tests/test_smoke_e2e.py``.

Translated checkerboards (written with the port's ``write_png``) go through
the port's ``Pipeline`` with the deterministic dummy extractor, matching
and geometric verification on the CPU, reconstruction skipped, and metrics
export; then the database invariants, the identity matches, the two-view
geometries and the exported JSON/CSV are checked.  The CLI runs the same
path in a subprocess without ``--skip-verification``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vit_colmap_tpu_torch.database import TWO_VIEW_CONFIG, ColmapDatabase
from vit_colmap_tpu_torch.features.dummy_extractor import DummyExtractor, dummy_features
from vit_colmap_tpu_torch.pipeline import Pipeline
from vit_colmap_tpu_torch.pipeline.match import match_exhaustive
from vit_colmap_tpu_torch.utils.config import Config, MatchingConfig
from vit_colmap_tpu_torch.utils.image_io import write_png

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """This file's many small tensor operations on one intra-op thread: six
    test workers share the machine's cores, and their threads' spinning
    otherwise slows such operations many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def make_checkerboards(image_dir, n=3, w=640, h=480, square=40):
    image_dir.mkdir(parents=True, exist_ok=True)
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(n):
        board = (((xx + i * 8) // square + yy // square) % 2 * 255).astype(np.uint8)
        write_png(image_dir / f"img_{i}.png", np.stack([board] * 3, axis=-1))


@pytest.fixture
def pipeline_run(tmp_path):
    image_dir = tmp_path / "images"
    make_checkerboards(image_dir)
    config = Config()
    config.camera.model = "PINHOLE"
    config.extractor.extractor_type = "dummy"
    config.do_reconstruction = False
    db_path = tmp_path / "db.db"
    report = Pipeline(config, device="cpu").run(
        image_dir=image_dir, output_dir=tmp_path / "out", db_path=db_path,
        dataset="smoke", scene="checker", results_dir=tmp_path / "results")
    return tmp_path, db_path, report


def test_pipeline_integration(pipeline_run):
    _, db_path, report = pipeline_run
    assert report["num_images"] == 3
    with ColmapDatabase.open_database(db_path) as db:
        assert db.num_cameras >= 1 and db.num_images == 3
        assert db.num_matched_pairs == 3
        for iid in db.read_images():
            k, d = db.read_keypoints(iid), db.read_descriptors(iid)
            assert k is not None and len(k) == 300 and len(d) == len(k)
            assert k.dtype == np.float32 and k.shape[1] == 2
            assert d.dtype == np.uint8 and d.shape[1] == 128


def test_dummy_matches_are_identity(pipeline_run):
    _, db_path, _ = pipeline_run
    with ColmapDatabase.open_database(db_path) as db:
        ids = sorted(db.read_images())
        m = db.read_matches(ids[0], ids[1])
    assert m is not None and len(m) == 300
    np.testing.assert_array_equal(m[:, 0], m[:, 1])


def test_verification_writes_two_view_geometries(pipeline_run):
    """Identical grids in every image: the identity homography explains
    every match, so each pair is PLANAR_OR_PANORAMIC with all its matches
    as inliers."""
    _, db_path, _ = pipeline_run
    with ColmapDatabase.open_database(db_path) as db:
        geoms = db.read_all_two_view_geometries()
        assert db.num_verified_pairs == 3
        for (a, b), g in geoms.items():
            assert g["config"] == TWO_VIEW_CONFIG["PLANAR_OR_PANORAMIC"]
            np.testing.assert_array_equal(g["inlier_matches"], db.read_matches(a, b))
            H = db.read_two_view_geometry(a, b)["H"]
            np.testing.assert_allclose(H, np.eye(3), atol=1e-3)


def test_pipeline_exports_metrics(pipeline_run):
    tmp_path, _, _ = pipeline_run
    json_path = tmp_path / "results" / "smoke" / "checker" / "dummy.json"
    data = json.loads(json_path.read_text())
    assert data["features"]["total_images"] == 3
    assert data["matching"]["matched_pairs"] == 3
    assert data["matching"]["verified_pairs"] == 3
    assert data["matching"]["config_distribution"] == {"PLANAR_OR_PANORAMIC": 3}
    assert data["reconstruction"] is None
    lines = (tmp_path / "results" / "summary.csv").read_text().strip().splitlines()
    assert len(lines) == 2 and lines[0].startswith("timestamp,dataset,scene")


def test_max_num_matches_cap(tmp_path):
    """MatchingConfig.max_num_matches bounds the stored matches per pair."""
    image_dir = tmp_path / "images"
    make_checkerboards(image_dir)
    db_path = tmp_path / "db.db"
    DummyExtractor(step=64, device="cpu").extract(image_dir, db_path, "PINHOLE", None)
    stats = match_exhaustive(db_path, MatchingConfig(max_num_matches=5,
                                                     do_verification=False), device="cpu")
    assert stats.matched_pairs == 3
    with ColmapDatabase.open_database(db_path) as db:
        ids = sorted(db.read_images())
        assert len(ids) == 3
        assert all(len(db.read_matches(a, b)) == 5
                   for i, a in enumerate(ids) for b in ids[i + 1:])


def test_dummy_descriptors_are_position_seeded():
    """Equal positions give equal descriptors in any image size; distinct
    positions distinct ones."""
    k1, d1 = dummy_features(42, 480, 640, device="cpu")
    k2, d2 = dummy_features(42, 240, 320, device="cpu")
    assert k1.shape == (300, 2) and d1.shape == (300, 128)
    pos1 = {tuple(p): i for i, p in enumerate(k1.int().tolist())}
    for j, p in enumerate(k2.int().tolist()):
        assert np.array_equal(d1[pos1[tuple(p)]].numpy(), d2[j].numpy())
    assert len({bytes(row) for row in d1.numpy()}) == 300
    assert not np.array_equal(d1.numpy(), dummy_features(7, 480, 640, device="cpu")[1].numpy())


def test_dummy_generates_images_when_empty(tmp_path):
    DummyExtractor(device="cpu").extract(tmp_path / "empty", tmp_path / "g.db", "PINHOLE")
    assert len(list((tmp_path / "empty").glob("*.png"))) == 10
    with ColmapDatabase.open_database(tmp_path / "g.db") as db:
        assert db.num_images == 10 and db.num_keypoints == 3000


def test_cli_verifies_on_cpu(tmp_path):
    """``python -m vit_colmap_tpu_torch.pipeline`` without
    ``--skip-verification`` writes two-view geometries; without
    ``--device`` it runs on CUDA, and raises where there is none."""
    image_dir = tmp_path / "images"
    make_checkerboards(image_dir)
    out = tmp_path / "out"
    cmd = [sys.executable, "-m", "vit_colmap_tpu_torch.pipeline", "--images", str(image_dir),
           "--output", str(out), "--db", str(out / "db.db"), "--extractor", "dummy",
           "--skip-reconstruction"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(cmd + ["--device", "cpu"], cwd=ROOT, capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr
    with ColmapDatabase.open_database(out / "db.db") as db:
        assert db.num_verified_pairs == 3
    assert "Verified 3 pairs" in proc.stderr
    if not torch.cuda.is_available():
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300,
                              env=env)
        assert proc.returncode != 0 and "CUDA is not available" in proc.stderr


def test_shard_descriptors_is_not_ported(tmp_path):
    make_checkerboards(tmp_path / "images", n=2)
    DummyExtractor(device="cpu").extract(tmp_path / "images", tmp_path / "s.db", "PINHOLE")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        match_exhaustive(tmp_path / "s.db", MatchingConfig(shard_descriptors=True),
                         device="cpu")


def test_run_returns_report_when_metrics_export_fails(tmp_path, monkeypatch):
    """A results directory that cannot be written (under a read-only
    directory, and under a regular file, which stops root too) costs the
    metrics, not the run: ``run`` logs the failure and returns its report,
    as the reference's ``extract_and_export_metrics`` does."""
    image_dir = tmp_path / "images"
    make_checkerboards(image_dir)
    locked = tmp_path / "locked"
    locked.mkdir()
    (locked / "not_a_dir").write_text("")
    locked.chmod(0o555)
    config = Config()
    config.extractor.extractor_type = "dummy"
    config.do_reconstruction = False
    from vit_colmap_tpu_torch.pipeline import run_pipeline

    logged = []
    monkeypatch.setattr(run_pipeline.logger, "exception", logged.append)
    try:
        report = Pipeline(config, device="cpu").run(
            image_dir=image_dir, output_dir=tmp_path / "out", db_path=tmp_path / "db.db",
            dataset="smoke", scene="checker", results_dir=locked / "not_a_dir" / "results")
    finally:
        locked.chmod(0o755)
    assert report is not None and report["num_images"] == 3
    assert report["verify_s"] >= 0
    assert logged == ["Metrics extraction failed"]
    assert not (locked / "not_a_dir" / "results").exists()
