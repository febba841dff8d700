"""The port's DTU and HPatches shell drivers (``scripts/torch_run_DTU_*.sh``,
``torch_run_HPatches_*.sh``) on the CPU, each run once on a tiny rendered
tree with ``--device cpu`` passed through to ``python -m
vit_colmap_tpu_torch.pipeline``.

The image selection of the JAX drivers (``*_3_r5000.png`` before any other
PNG for DTU; ``.ppm``, ``.png``, ``.jpg`` for HPatches, whose sequence is
written here as PNG since neither package's pipeline lists ``.ppm``), the
database under
``$OUTPUT_ROOT/intermediate/<dataset>/<scene>/``, the camera model (PINHOLE
for DTU, SIMPLE_RADIAL for HPatches) and the metric export
(``$OUTPUT_ROOT/results/<dataset>/<scene>/<extractor>.json``).  Every run
writes only under the test's temporary ``OUTPUT_ROOT``.
"""

import json
import os
import shutil
import sqlite3
import subprocess
from pathlib import Path

import pytest

from vit_colmap_tpu_torch.dataloader.synthetic_benchmark import (
    generate_synthetic_hpatches,
    render_multiview_scene,
)
from vit_colmap_tpu_torch.utils.image_io import imread_rgb, write_png

REPO = Path(__file__).resolve().parents[1]
SMALL = ["--device", "cpu", "--backbone", "vits14", "--max-keypoints", "256",
         "--sfm-max-keypoints", "256"]


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """A DTU-style scan (five diffuse *_3_r5000.png views and a decoy PNG)
    and an HPatches sequence, both small."""
    tmp = tmp_path_factory.mktemp("drivers")
    render_multiview_scene(tmp / "render", n_cams=5, size=(126, 168), focal=158.0, seed=7)
    scan = tmp / "scan1"
    scan.mkdir()
    for i, f in enumerate(sorted((tmp / "render").glob("*.png"))):
        shutil.copy(f, scan / f"rect_{i + 1:03d}_3_r5000.png")
    shutil.copy(scan / "rect_001_3_r5000.png", scan / "rect_001_0_r5000.png")  # not diffuse
    generate_synthetic_hpatches(tmp / "hpatches", n_illum=0, n_view=1, n_img=3,
                                size=(126, 168), seed=0)
    # As PNG: the pipeline of either package lists no .ppm (ROADMAP.md, Queue 3).
    seq = tmp / "v_synth0"
    seq.mkdir()
    for f in sorted((tmp / "hpatches" / "v_synth0").glob("*.ppm")):
        write_png(seq / f"{f.stem}.png", imread_rgb(f))
    return {"tmp": tmp, "scan": scan, "seq": seq}


def run(script, args, env_extra, tmp):
    env = {**os.environ, **env_extra, "OUTPUT_ROOT": str(tmp / "out"),
           "OMP_NUM_THREADS": "2"}
    return subprocess.run(["bash", str(REPO / "scripts" / script), *args], env=env,
                          capture_output=True, text=True, timeout=120)


def camera_models(db):
    with sqlite3.connect(db) as conn:
        return {m for (m,) in conn.execute("SELECT model FROM cameras")}


@pytest.mark.parametrize("script, extractor, env", [
    ("torch_run_DTU_sift.sh", "colmap_sift", {}),
    ("torch_run_DTU_vit.sh", "vit", {}),
    ("torch_run_DTU_trainable_vit.sh", "trainable_vit", {"VIT_WEIGHTS": ""}),
])
def test_dtu_driver(trees, script, extractor, env):
    tmp = trees["tmp"] / extractor
    res = run(script, [str(trees["scan"]), "scan1", *SMALL], env, tmp)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "Linked 5 images for DTU/scan1" in res.stdout
    work = tmp / "out" / "intermediate" / "DTU" / "scan1"
    assert sorted(p.name for p in (work / "images").iterdir()) == [
        f"rect_{i:03d}_3_r5000.png" for i in range(1, 6)]
    assert camera_models(work / "database.db") == {1}  # PINHOLE
    metrics = json.loads((tmp / "out" / "results" / "DTU" / "scan1" /
                          f"{extractor}.json").read_text())
    assert metrics["extractor_type"] == extractor and metrics["dataset"] == "DTU"


@pytest.mark.parametrize("script, extractor", [
    ("torch_run_HPatches_sift.sh", "colmap_sift"),
    ("torch_run_HPatches_trainable_vit.sh", "trainable_vit"),
])
def test_hpatches_driver(trees, script, extractor):
    tmp = trees["tmp"] / f"hp_{extractor}"
    seq = trees["seq"]
    res = run(script, [str(seq), "", *SMALL], {}, tmp)  # empty scene: the sequence's name
    assert res.returncode == 0, res.stderr[-3000:]
    assert f"Linked 3 images for HPatches/{seq.name}" in res.stdout
    work = tmp / "out" / "intermediate" / "HPatches" / seq.name
    assert camera_models(work / "database.db") == {2}  # SIMPLE_RADIAL
    assert (tmp / "out" / "results" / "HPatches" / seq.name / f"{extractor}.json").exists()
