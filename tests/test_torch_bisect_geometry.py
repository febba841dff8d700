"""The port's geometry bisection (``scripts/torch_bisect_geometry.py``)
against the JAX script (``scripts/bisect_geometry.py``) on the CPU.

* ``siftloc``: the trainable head's descriptors resampled at one image's
  SIFT keypoints, renormalized and quantized, within one uint8 step of the
  JAX script's ``replace_desc_with_trainable`` on the same database, image
  and weights (the tiny backbone of ``tests/test_torch_trainable_
  extractor.py``, full-width heads, f32 on both sides, visible random
  weights carried across with ``models/convert``).  The image is 120 x 150,
  so both read it and shrink it to 112 x 140 (``resize_area`` against
  OpenCV's ``INTER_AREA``) before the heads run.
* ``--tiny`` with the ``siftloc`` variant prints the JAX script's lines and
  keys, on the rendered 6-view scene.
* The dispersion statistics equal the JAX script's.
"""

import json
import shutil
import types

import numpy as np
import pytest
import torch

import scripts.bisect_geometry as jbis
import scripts.torch_bisect_geometry as tbis
from tests.test_torch_trainable_extractor import _extractors, tiny_backbone  # noqa: F401
from vit_colmap_tpu.features import trainable_vit_extractor as jtve
from vit_colmap_tpu_torch.database import ColmapDatabase
from vit_colmap_tpu_torch.dataloader.synthetic_benchmark import make_structured_image
from vit_colmap_tpu_torch.features.sift_extractor import SiftExtractor
from vit_colmap_tpu_torch.utils.image_io import write_png


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def descriptors(db_path):
    with ColmapDatabase.open_database(db_path) as db:
        return {i: db.read_descriptors(i) for i in db.read_images()}


def test_siftloc_descriptors_within_one_step_of_jax(tmp_path, monkeypatch):
    images = tmp_path / "images"
    images.mkdir()
    write_png(images / "a.png", make_structured_image(np.random.default_rng(2), 120, 150))
    db = tmp_path / "port.db"
    SiftExtractor(max_keypoints=128, device="cpu").extract(images, db, "PINHOLE")
    shutil.copy(db, tmp_path / "jax.db")
    before = descriptors(db)

    jex, tex = _extractors()
    tbis.resample_descriptors(tex, images, db)
    monkeypatch.setattr(jtve, "TrainableViTExtractor", lambda **kw: jex)
    jbis.replace_desc_with_trainable(images, tmp_path / "jax.db",
                                     types.SimpleNamespace(weights=None, backbone="tiny"))
    ours, ref = descriptors(db)[1], descriptors(tmp_path / "jax.db")[1]
    assert ours.shape == ref.shape == (len(before[1]), 128) and len(ours) > 20
    assert ours.dtype == np.uint8
    assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 1
    assert not np.array_equal(ours, before[1])  # SIFT's bytes were replaced


def test_tiny_run_prints_the_jax_keys(tmp_path, capsys):
    out = tbis.main(["--tiny", "--device", "cpu", "--variants", "siftloc",
                     "--work-dir", str(tmp_path)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "=== variant: siftloc ==="
    assert json.loads(lines[-1]) == out
    assert set(out) == {"metric", "value", "unit", "images", "weights", "variants"}
    row = out["variants"]["siftloc"]
    assert {"match_s", "recon_s", "registered", "points3d", "extract_s",
            "keypoint_dispersion", "dispatch_rt_ms", "dispatch_rt_ms_before"} <= set(row)
    assert row["dispatch_rt_ms"] is None and row["keypoint_dispersion"]["n"] > 0
    assert out["metric"] == "bisect_rot_err_deg_asis" and out["value"] is None


def test_spatial_stats_equal_jax():
    rng = np.random.default_rng(0)
    k = rng.random((300, 2)) * [640, 480]
    assert tbis.spatial_stats(k, 640, 480) == jbis.spatial_stats(k, 640, 480)
    assert tbis.spatial_stats(np.zeros((0, 2)), 64, 48) == jbis.spatial_stats(
        np.zeros((0, 2)), 64, 48)
