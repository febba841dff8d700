"""The port's serving mode (``vit_colmap_tpu_torch.pipeline.serve``) on the
CPU: the five cases of ``tests/test_serve.py`` run against the port, and one
parity case against the JAX package's server (the same two jobs, dummy
extractor, verification and reconstruction off: equal keypoint and match
rows)."""

import json
import sqlite3

import numpy as np
import pytest

from vit_colmap_tpu_torch.database import ColmapDatabase
from vit_colmap_tpu_torch.pipeline.serve import PipelineServer, SceneJob, _iter_jobs, main
from vit_colmap_tpu_torch.utils.config import Config
from vit_colmap_tpu_torch.utils.image_io import write_png


def _write_scene(image_dir, n=3, w=320, h=240, square=40, shift_step=8):
    image_dir.mkdir(parents=True, exist_ok=True)
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(n):
        board = (((xx + i * shift_step) // square + yy // square) % 2 * 255).astype(np.uint8)
        write_png(image_dir / f"img_{i}.png", np.stack([board] * 3, axis=-1))


def _config(cfg_cls=Config):
    config = cfg_cls()
    config.camera.model = "PINHOLE"
    config.extractor.extractor_type = "dummy"
    config.do_matching = True
    config.do_reconstruction = False
    return config


def test_server_runs_scenes_with_one_warm_extractor(tmp_path):
    for name in ("a", "b"):
        _write_scene(tmp_path / name / "images")
    server = PipelineServer(_config(), device="cpu")
    jobs = [SceneJob(image_dir=tmp_path / name / "images", output_dir=tmp_path / name / "out")
            for name in ("a", "b")]
    results = server.serve(jobs)

    assert [r.ok for r in results] == [True, True]
    for name in ("a", "b"):
        with ColmapDatabase.open_database(tmp_path / name / "out" / "database.db") as db:
            assert db.num_images == 3
            assert db.num_matched_pairs >= 1
    # One extractor served both scenes.
    assert len(server.pipeline._extractors) == 1
    for r in results:
        assert r.report["num_images"] == 3
        assert r.report["extract_s"] >= 0
        assert r.report["total_s"] >= r.report["extract_s"]


def test_server_rewrites_stale_db_and_survives_bad_job(tmp_path):
    _write_scene(tmp_path / "images")
    out = tmp_path / "out"
    out.mkdir()
    (out / "database.db").write_bytes(b"stale non-sqlite bytes")
    server = PipelineServer(_config(), device="cpu")
    # A missing image_dir is no failure for the dummy extractor (it writes
    # 10 images there); a regular file in its place raises inside the job.
    not_a_dir = tmp_path / "not_a_dir"
    not_a_dir.write_text("plain file where a directory should be")
    bad = SceneJob(image_dir=not_a_dir, output_dir=tmp_path / "o2")
    good = SceneJob(image_dir=tmp_path / "images", output_dir=out)
    results = server.serve([bad, good])
    assert [r.ok for r in results] == [False, True]
    assert results[0].error
    with ColmapDatabase.open_database(out / "database.db") as db:
        assert db.num_images == 3


def test_iter_jobs_parses_and_skips_malformed_lines():
    lines = [
        json.dumps({"image_dir": "/a", "output_dir": "/b", "scene": "s"}),
        "not json",
        "# comment",
        "",
        json.dumps({"image_dir": "/a"}),  # missing output_dir
        json.dumps({"image_dir": "/a", "output_dir": "/b", "bogus": 1}),
    ]
    jobs = list(_iter_jobs(lines))
    assert len(jobs) == 1
    assert jobs[0].scene == "s"
    assert jobs[0].db_path is None


def test_serve_cli_end_to_end(tmp_path):
    _write_scene(tmp_path / "images")
    jobs_file = tmp_path / "jobs.jsonl"
    jobs_file.write_text(json.dumps({"image_dir": str(tmp_path / "images"),
                                     "output_dir": str(tmp_path / "out")}) + "\n")
    report = tmp_path / "report.json"
    main(["--jobs", str(jobs_file), "--extractor", "dummy", "--camera-model", "PINHOLE",
          "--skip-reconstruction", "--report-json", str(report), "--device", "cpu"])
    rows = json.loads(report.read_text())
    assert len(rows) == 1 and rows[0]["ok"]
    assert rows[0]["num_images"] == 3


def test_all_failed_jobs_exit_nonzero(tmp_path):
    not_a_dir = tmp_path / "not_a_dir"
    not_a_dir.write_text("plain file where a directory should be")
    jobs_file = tmp_path / "jobs.jsonl"
    jobs_file.write_text(json.dumps({"image_dir": str(not_a_dir),
                                     "output_dir": str(tmp_path / "out")}) + "\n")
    with pytest.raises(SystemExit) as exc:
        main(["--jobs", str(jobs_file), "--extractor", "dummy", "--skip-reconstruction",
              "--device", "cpu"])
    assert exc.value.code == 1


def _table(db_path, sql):
    con = sqlite3.connect(db_path)
    try:
        return con.execute(sql).fetchall()
    finally:
        con.close()


def test_server_matches_jax_server(tmp_path):
    from vit_colmap_tpu.pipeline.serve import PipelineServer as JaxServer
    from vit_colmap_tpu.pipeline.serve import SceneJob as JaxJob
    from vit_colmap_tpu.utils.config import Config as JaxConfig

    for name in ("a", "b"):
        _write_scene(tmp_path / name / "images", shift_step=8 if name == "a" else 16)
    servers = {}
    for side, server_cls, job_cls, cfg_cls, kw in (
        ("jax", JaxServer, JaxJob, JaxConfig, {}),
        ("port", PipelineServer, SceneJob, Config, {"device": "cpu"}),
    ):
        cfg = _config(cfg_cls)
        cfg.matching.do_verification = False
        server = server_cls(cfg, **kw)
        results = server.serve([job_cls(image_dir=tmp_path / n / "images",
                                        output_dir=tmp_path / side / n) for n in ("a", "b")])
        assert [r.ok for r in results] == [True, True]
        servers[side] = server
    for n in ("a", "b"):
        jdb, tdb = tmp_path / "jax" / n / "database.db", tmp_path / "port" / n / "database.db"
        for sql in ("SELECT image_id, rows, cols, data FROM keypoints ORDER BY image_id",
                    "SELECT pair_id, rows, cols, data FROM matches ORDER BY pair_id"):
            ref, out = _table(jdb, sql), _table(tdb, sql)
            assert ref == out and len(ref) > 0
