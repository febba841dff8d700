"""The port's HPatches dataset, its training CLI, its checkpoints and the
extractors that load them, on the CPU.

* ``HPatchesDataset`` against the JAX package's on one tree (every pair
  mode and split, synthetic pairs and the photometric jitter drawn from
  the same seed): the same samples, homographies bit for bit, the first
  images within OpenCV's ``INTER_AREA`` rounding (1 level), the second
  images of real pairs within 3 levels (that level through the jitter's
  contrast and gamma) and of synthetic pairs within the warp's rounding
  (mean |diff| <= 1, 99th percentile <= 8); images grown to a larger
  target equal byte for byte; ``train_val_split`` equal;
  ``--synthetic-only``'s pair stream likewise against the JAX package's.
* The CLI (``python -m vit_colmap_tpu_torch.training.train``, in process)
  at ``--synthetic-image-size 56``: checkpoints, ``meta.json`` and
  ``scalars.jsonl``; ``--resume latest`` continues the step count and
  ``--resume best_model`` refuses; ``best_model`` loads into
  ``TrainableViTExtractor`` and ``Pipeline.run`` writes the database
  contract on two images (``tests/test_train_to_inference.py``'s seam);
  a ``--train-backbone`` checkpoint loads into ``ViTExtractor`` with the
  backbone ``TrainableViTExtractor`` restores, and a heads-only one raises.
"""

import json
import shutil

import cv2
import numpy as np
import pytest
import torch

from tests.test_dataset import _make_hpatches_tree
from vit_colmap_tpu.dataloader import hpatches_dataset as jds
from vit_colmap_tpu_torch.dataloader import hpatches_dataset as tds
from vit_colmap_tpu_torch.training import train as ttrain

@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Small tensor operations on 2 intra-op threads: test workers
    share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


TRAIN_ARGS = ["--synthetic-only", "--synthetic-image-size", "56", "--backbone", "vits14",
              "--batch-size", "2", "--steps-per-epoch", "2", "--top-k", "16",
              "--log-interval", "1", "--device", "cpu"]


def _close_images(a, b, kind):
    d = np.abs(a.astype(int) - b.astype(int))
    if kind == "resize":
        assert d.max() <= 1, d.max()
    elif kind == "jitter":  # a resize's level through the jitter's gain
        assert d.max() <= 3, d.max()
    else:
        assert d.mean() <= 1.0 and np.percentile(d, 99) <= 8, (d.mean(), np.percentile(d, 99))


@pytest.mark.parametrize("pair_mode,split", [("reference_only", "all"),
                                             ("consecutive", "train"),
                                             ("all_pairs", "viewpoint")])
def test_hpatches_dataset_matches_jax(tmp_path, pair_mode, split):
    _make_hpatches_tree(tmp_path, n_seq_i=2, n_seq_v=1, n_img=4, size=(60, 80))
    kw = dict(split=split, pair_mode=pair_mode, target_height=56, target_width=70,
              synthetic_ratio=0.5, photometric_strength=0.8, seed=3)
    jd = jds.HPatchesDataset(tmp_path, **kw)
    td = tds.HPatchesDataset(tmp_path, **kw)
    assert len(td) == len(jd) > 0
    assert [s.name for s in td.sequences] == [s.name for s in jd.sequences]
    for a, b in zip(jd.samples, td.samples):
        assert (a["seq"], a["idx1"], a["idx2"], a["synthetic"]) == (
            b["seq"], b["idx1"], b["idx2"], b["synthetic"])
        if not a["synthetic"]:
            np.testing.assert_array_equal(b["H"], a["H"])
    assert any(s["synthetic"] for s in td.samples)
    for k in range(len(jd)):
        a, b = jd[k], td[k]
        np.testing.assert_array_equal(b["H"], a["H"])
        assert b["image1"].shape == (56, 70, 3) and b["image2"].shape == (56, 70, 3)
        _close_images(a["image1"], b["image1"], "resize")
        _close_images(a["image2"], b["image2"], "warp" if a["is_synthetic"] else "jitter")
        assert (b["seq_name"], b["pair_idx"], b["is_synthetic"]) == (
            a["seq_name"], a["pair_idx"], a["is_synthetic"])
    assert jd.rng.random() == td.rng.random()  # the same draws in the same order
    assert tds.train_val_split(td, 0.2, seed=1) == jds.train_val_split(jd, 0.2, seed=1)
    jb = list(jd.batches(4, seed=2))
    tb = list(td.batches(4, seed=2))
    assert len(tb) == len(jb)
    for a, b in zip(jb, tb):
        assert {k: v.shape for k, v in b.items()} == {k: v.shape for k, v in a.items()}


def test_hpatches_dataset_grows_images_as_jax(tmp_path):
    """A target above the images' size: OpenCV's growing INTER_AREA, the
    same bytes for real pairs."""
    _make_hpatches_tree(tmp_path, n_seq_i=1, n_seq_v=1, n_img=3, size=(60, 80))
    kw = dict(pair_mode="all_pairs", target_height=112, target_width=154, seed=4)
    jd = jds.HPatchesDataset(tmp_path, **kw)
    td = tds.HPatchesDataset(tmp_path, **kw)
    assert len(td) == len(jd) == 6
    for k in range(len(jd)):
        a, b = jd[k], td[k]
        np.testing.assert_array_equal(b["H"], a["H"])
        for key in ("image1", "image2"):
            assert b[key].shape == (112, 154, 3)
            np.testing.assert_array_equal(b[key], a[key])


def test_synthetic_batches_match_jax():
    from vit_colmap_tpu.training.train import _synthetic_batches as jbatches

    ja = list(jbatches(2, 56, 56, 3, "moderate", 5, photometric=0.5))
    ta = list(ttrain._synthetic_batches(2, 56, 56, 3, "moderate", 5, photometric=0.5))
    for a, b in zip(ja, ta):
        np.testing.assert_array_equal(b["H"], a["H"])
        # cv2's uint8 INTER_CUBIC rounds in fixed point: one level.
        assert np.abs(b["image1"].astype(int) - a["image1"]).max() <= 1
        _close_images(a["image2"], b["image2"], "warp")


def test_prefetch_keeps_order_and_raises_the_stream_error():
    def stream():
        yield from range(5)
        raise OSError("unreadable")

    got = []
    with pytest.raises(OSError, match="unreadable"):
        for item in ttrain.prefetch(stream()):
            got.append(item)
    assert got == [0, 1, 2, 3, 4]
    assert list(ttrain.prefetch(iter(range(7)), depth=1)) == list(range(7))


def test_parser_has_the_jax_flags_and_defaults():
    from vit_colmap_tpu.training.train import build_argparser as jparser

    j = vars(jparser().parse_args([]))
    t = vars(ttrain.build_argparser().parse_args([]))
    assert t.pop("device") is None
    assert t == j


@pytest.fixture(scope="module")
def frozen_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("train") / "ckpt"
    ttrain.main(TRAIN_ARGS + ["--epochs", "1", "--output-dir", str(out)])
    return out


def test_cli_writes_checkpoints_and_resumes(frozen_run, tmp_path):
    assert json.loads((frozen_run / "meta.json").read_text()) == {
        "epoch": 1, "step": 2, "train_backbone": False}
    lines = [json.loads(x) for x in (frozen_run / "scalars.jsonl").read_text().splitlines()]
    assert [x["event"] for x in lines] == ["train", "train", "val"]
    assert all(np.isfinite(x["total_loss"]) for x in lines)
    assert {"detector_loss", "descriptor_loss", "nce_loss", "step_s"} <= set(lines[0])
    for name in ("latest", "checkpoint_epoch_0001", "best_model"):
        assert (frozen_run / name / "state.pt").exists()
    best = torch.load(frozen_run / "best_model" / "state.pt", weights_only=True)
    assert set(best) == {"heads"}  # parameters only
    latest = torch.load(frozen_run / "latest" / "state.pt", weights_only=True)
    assert set(latest) == {"heads", "step", "optimizer"} and latest["step"] == 2

    ckpt = tmp_path / "ckpt"
    shutil.copytree(frozen_run, ckpt)
    ttrain.main(TRAIN_ARGS + ["--epochs", "2", "--output-dir", str(ckpt),
                              "--resume", str(ckpt / "latest")])
    meta = json.loads((ckpt / "meta.json").read_text())
    assert meta["epoch"] == 2 and meta["step"] == 4  # continued, not restarted
    assert (ckpt / "checkpoint_epoch_0002").exists()
    with pytest.raises(SystemExit, match="not a full-state checkpoint"):
        ttrain.main(TRAIN_ARGS + ["--epochs", "1", "--output-dir", str(tmp_path / "x"),
                                  "--resume", str(ckpt / "best_model")])


def _two_images(d):
    """Two 70 x 84 crops of one blurred random image, one patch (14 px)
    apart: random backbone tokens match only across whole-patch shifts."""
    from vit_colmap_tpu_torch.utils.image_io import write_png

    d.mkdir()
    rng = np.random.default_rng(0)
    img = cv2.GaussianBlur(rng.integers(0, 255, (70, 98, 3), dtype=np.uint8), (0, 0), 1.5)
    write_png(d / "a.png", img[:, :84])
    write_png(d / "b.png", img[:, 14:])


def test_checkpoint_runs_the_trainable_pipeline(frozen_run, tmp_path):
    from vit_colmap_tpu_torch.database import ColmapDatabase
    from vit_colmap_tpu_torch.pipeline import Pipeline
    from vit_colmap_tpu_torch.utils.config import Config

    _two_images(tmp_path / "imgs")
    cfg = Config()
    cfg.extractor.extractor_type = "trainable_vit"
    cfg.extractor.backbone = "vits14"
    cfg.extractor.vit_weights_path = str(frozen_run / "best_model")
    cfg.extractor.sfm_max_keypoints = 64
    cfg.extractor.image_batch = 1
    cfg.do_reconstruction = False
    pipe = Pipeline(cfg, device="cpu")
    report = pipe.run(tmp_path / "imgs", tmp_path / "out", tmp_path / "db.db")
    assert report["num_images"] == 2
    ex = next(iter(pipe._extractors.values()))
    heads = torch.load(frozen_run / "best_model" / "state.pt", weights_only=True)["heads"]
    for k, v in ex.model.heads.state_dict().items():
        assert torch.equal(v.cpu(), heads[k]), k
    with ColmapDatabase.open_database(tmp_path / "db.db") as db:
        assert db.num_images == 2
        for iid in db.read_images():
            k, d = db.read_keypoints(iid), db.read_descriptors(iid)
            assert k.shape[1] == 6 and 0 < len(k) <= 64
            assert d.shape == (len(k), 128) and d.dtype == np.uint8
        assert db.num_matches > 0


def test_finetuned_checkpoint_loads_into_both_extractors(frozen_run, tmp_path):
    from vit_colmap_tpu_torch.features.trainable_vit_extractor import TrainableViTExtractor
    from vit_colmap_tpu_torch.features.vit_extractor import ViTExtractor

    ckpt = tmp_path / "ckpt_bb"
    ttrain.main(TRAIN_ARGS + ["--epochs", "1", "--output-dir", str(ckpt),
                              "--train-backbone", "--backbone-lr-scale", "0.5"])
    assert json.loads((ckpt / "meta.json").read_text())["train_backbone"]
    kw = dict(backbone="vits14", image_batch=1, device="cpu")
    ex = TrainableViTExtractor(weights_path=str(ckpt / "best_model"), num_keypoints=64, **kw)
    fresh = TrainableViTExtractor(weights_path=None, num_keypoints=64, **kw)
    tuned = ex.model.backbone.state_dict()
    assert any(not torch.equal(v, fresh.model.backbone.state_dict()[k])
               for k, v in tuned.items()), "fine-tuned backbone was not restored"
    for name in ("best_model", "latest"):
        fz = ViTExtractor(weights_path=str(ckpt / name), max_keypoints=64, **kw)
        for k, v in fz.model.state_dict().items():
            assert torch.equal(v, tuned[k]), (name, k)
    with pytest.raises(ValueError, match="no backbone"):
        ViTExtractor(weights_path=str(frozen_run / "best_model"), max_keypoints=64, **kw)
