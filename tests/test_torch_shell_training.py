"""The port's training shell drivers (``scripts/torch_run_training.sh``,
``torch_resume_training.sh``) and the match viewer's cookbook
(``torch_run_visualize_matches.sh``) on the CPU, each run once on tiny
inputs with ``--device cpu`` passed through.

* ``torch_run_training.sh``: the JAX driver's hyperparameters (all_pairs,
  synthetic ratio 0.5, alpha_orient 0.32, batch 4, 20 epochs), overridden
  by the flags after the data root (1 epoch of 1 step at vits14, 112 x 140);
  checkpoints under ``$CHECKPOINTS``.
* ``torch_resume_training.sh``: resumes from ``$CHECKPOINTS/latest`` (its
  ``CKPT`` default) and trains the second epoch.
* ``torch_run_visualize_matches.sh``: draws one pair of a database the
  port's pipeline wrote.
"""

import json
import os
import subprocess
from pathlib import Path

import pytest

from vit_colmap_tpu_torch.dataloader.synthetic_benchmark import (
    generate_synthetic_hpatches,
    render_multiview_scene,
)
from vit_colmap_tpu_torch.pipeline import Pipeline
from vit_colmap_tpu_torch.utils.config import Config

REPO = Path(__file__).resolve().parents[1]
TRAIN = ["--epochs", "1", "--steps-per-epoch", "1", "--batch-size", "2", "--backbone",
         "vits14", "--target-height", "112", "--target-width", "140", "--top-k", "16",
         "--log-interval", "1", "--device", "cpu"]


def run(script, args, env_extra):
    env = {**os.environ, **env_extra, "OMP_NUM_THREADS": "2"}
    return subprocess.run(["bash", str(REPO / "scripts" / script), *args], env=env,
                          capture_output=True, text=True, timeout=120)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train")
    generate_synthetic_hpatches(tmp / "hpatches", n_illum=1, n_view=1, n_img=3,
                                size=(112, 140), seed=0)
    return tmp


def test_training_then_resume(tree):
    ck = tree / "ck"
    env = {"CHECKPOINTS": str(ck)}
    res = run("torch_run_training.sh", [str(tree / "hpatches"), *TRAIN], env)
    assert res.returncode == 0, res.stderr[-3000:]
    assert json.loads((ck / "meta.json").read_text())["epoch"] == 1  # the next epoch
    assert (ck / "latest" / "state.pt").exists()

    res = run("torch_resume_training.sh", [str(tree / "hpatches"), *TRAIN, "--epochs", "2"],
              env)
    assert res.returncode == 0, res.stderr[-3000:]
    meta = json.loads((ck / "meta.json").read_text())
    assert meta["epoch"] == 2 and meta["step"] == 2
    lines = [json.loads(l) for l in (ck / "scalars.jsonl").read_text().splitlines()]
    assert [l["step"] for l in lines if l.get("event") == "train"] == [1, 2]


def test_visualize_matches_cookbook(tree):
    _, K = render_multiview_scene(tree / "scene", n_cams=3, size=(126, 168), focal=158.0,
                                  seed=7)
    config = Config()
    config.extractor.extractor_type = "sift"
    config.extractor.max_keypoints = 256
    config.camera.model = "PINHOLE"
    config.camera.params = [float(K[0, 0]), float(K[1, 1]), float(K[0, 2]), float(K[1, 2])]
    config.do_reconstruction = False
    db = tree / "viz.db"
    Pipeline(config, device="cpu").run(tree / "scene", tree / "viz_out", db)
    out = tree / "pair.png"
    res = run("torch_run_visualize_matches.sh", ["--output", str(out)],
              {"DB": str(db), "IMAGES": str(tree / "scene")})
    assert res.returncode == 0, res.stderr[-3000:]
    assert out.stat().st_size > 1000
