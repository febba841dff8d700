"""The port's serving benchmark (``scripts/torch_bench_serve.py``) on the CPU.

* ``--tiny`` prints one JSON line with the keys of ``scripts/bench_serve.py``'s
  line, one scene report a job, every job ok.
* Each scene's report equals a fresh ``Pipeline.run`` of that scene (images,
  registered images, 3D points, verification chunks; every field but the
  seconds), and the two databases hold the same verified pairs: serving
  many scenes from one warm process changes no result.
"""

import json
import sqlite3

import pytest
import torch

import scripts.torch_bench_serve as tbs
from vit_colmap_tpu_torch.pipeline import Pipeline


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


JAX_KEYS = {"metric", "value", "unit", "cold", "warm_mean", "amortization_x", "total_s",
            "n_scenes", "images_per_scene", "extractor", "platform", "scenes"}


def verified(db_path):
    with sqlite3.connect(db_path) as conn:
        return conn.execute("SELECT pair_id, rows, config, data FROM two_view_geometries "
                            "ORDER BY pair_id").fetchall()


def test_tiny_serve_equals_pipeline_runs(tmp_path, capsys):
    out = tbs.main(["--tiny", "--device", "cpu", "--work-dir", str(tmp_path)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == JAX_KEYS and line["metric"] == "serve_scene_wall_s"
    assert line["platform"] == "cpu" and line["n_scenes"] == 2
    assert len(out["scenes"]) == 2 and all(s["ok"] for s in out["scenes"])
    assert line["amortization_x"] is not None

    jobs, cam_params = tbs.scene_jobs(tmp_path, 2, 5, 126, 168)
    config = tbs.serve_config("sift", 256, cam_params, False)
    timing = {"wall_s", "extract_s", "match_verify_s", "reconstruction_s", "total_s",
              "match_s", "verify_s", "image_dir", "output_dir"}
    for job, served in zip(jobs, out["scenes"]):
        db = job.output_dir.parent / "fresh.db"
        report = Pipeline(config, device="cpu").run(job.image_dir, job.output_dir.parent /
                                                    "fresh", db)
        want = {k: v for k, v in report.items() if k not in timing}
        got = {k: v for k, v in served.items() if k not in timing | {"ok"}}
        assert got == want
        assert want["num_images"] == 5 and want.get("registered_images", 0) >= 2
        assert verified(job.output_dir / "database.db") == verified(db)
