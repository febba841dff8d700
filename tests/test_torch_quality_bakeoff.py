"""The port's quality bake-off (``scripts/torch_quality_bakeoff.py``) against
``scripts/quality_bakeoff.py``, on the CPU.

* ``to_markdown``: byte for byte the JAX script's, on the committed
  ``results/quality/QUALITY.json`` (read, never written) and on small
  results dicts (the same and the dedicated training tree, with and without
  the held-out section and pose errors), the clock fixed on both sides.
* ``_weights_label``: the same label for every row name.
* ``--md-only``: QUALITY.md from an existing QUALITY.json, equal to the JAX
  script's markdown.
* A small run (126 x 168, one sequence of each kind, 3 images, a tiny
  backbone: depth 2, width 128) on the CPU: every row written, earlier rows
  kept, the trained row's checkpoint holding the trained heads and the
  ``--weights`` backbone; the held-out tree as the JAX script's builder
  writes it (the same files and homographies, pixels within the mean bound
  of ``tests/test_torch_training_geometry.py``).
"""

import argparse
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import scripts.quality_bakeoff as jbake
import scripts.torch_quality_bakeoff as tbake
from vit_colmap_tpu_torch.models import dinov2 as tdino
from vit_colmap_tpu_torch.models.dinov2 import make_backbone
from vit_colmap_tpu_torch.training.checkpoint import load_checkpoint
from vit_colmap_tpu_torch.utils.image_io import imread_rgb

ROOT = Path(__file__).resolve().parent.parent
COMMITTED = ROOT / "results" / "quality" / "QUALITY.json"
TINY = dict(embed_dim=128, depth=2, num_heads=2, mlp_ratio=4.0, swiglu=False)
SMALL = ["--height", "126", "--width", "168", "--n-illum", "1", "--n-view", "1",
         "--n-img", "3", "--recon-cams", "4", "--max-keypoints", "128", "--backbone", "tiny",
         "--epochs", "1", "--steps-per-epoch", "2", "--batch-size", "1", "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """The test workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def fixed_clock(monkeypatch):
    monkeypatch.setattr(time, "strftime", lambda fmt, *a: "2026-01-02 03:04")


def _hp_row(rng, label=None):
    r = {"pairs": int(rng.integers(1, 50)), "avg_matches": float(rng.uniform(0, 900)),
         "mma": {k: float(rng.random()) for k in ("1.0", "3.0", "5.0")},
         "homography_accuracy": {k: float(rng.random()) for k in ("1.0", "3.0", "5.0")},
         "pairs_per_sec": float(rng.uniform(0.1, 9))}
    if label:
        r["weights_label"] = label
    return r


def _recon_row(rng, pose: bool, rec: bool = True):
    r = {"features": {}, "matching": {"inlier_ratio": float(rng.random()),
                                      "verified_pairs": int(rng.integers(0, 30))},
         "reconstruction": ({"registered_images": int(rng.integers(0, 9)),
                             "total_3d_points": int(rng.integers(0, 9000)),
                             "avg_track_length": float(rng.uniform(2, 6)),
                             "avg_reprojection_error": float(rng.uniform(0, 2))}
                            if rec else None),
         "wall_clock_s": float(rng.uniform(1, 90))}
    if pose:
        r["pose_vs_gt"] = {"pose_rot_err_deg_mean": float(rng.uniform(0, 3)),
                           "pose_center_err_rel_mean": float(rng.uniform(0, 0.1)),
                           "aligned_cameras": int(rng.integers(3, 9))}
    return r


def _small_results(seed: int, train_tree: str, holdout: bool) -> dict:
    rng = np.random.default_rng(seed)
    names = ["sift", "vit", "trainable_vit", "trainable_vit_trained", "hybrid"]
    res = {"meta": {"device": "NVIDIA H100 80GB HBM3, 700.00 W", "backbone": "vitb14",
                    "weights_note": "random-init backbone (no pretrained weights in env)",
                    "image_size": [480, 640], "max_keypoints": 2048,
                    "train_tree": train_tree},
           "hpatches": {n: _hp_row(rng, "custom label" if n == "hybrid" else None)
                        for n in names},
           "hpatches_holdout": ({n: _hp_row(rng) for n in names[:2]} if holdout else {}),
           "reconstruction": {n: _recon_row(rng, pose=i % 2 == 0, rec=i != 3)
                              for i, n in enumerate(names)}}
    return res


@pytest.mark.parametrize("case", ["committed", "same_tree_holdout", "big_tree_no_holdout",
                                  "no_train_tree_key"])
def test_to_markdown_equals_jax(fixed_clock, case):
    if case == "committed":
        results = json.loads(COMMITTED.read_text())
    else:
        results = _small_results(len(case), "big" if "big" in case else "same",
                                 "holdout" in case and "no_holdout" not in case)
        if case == "no_train_tree_key":
            del results["meta"]["train_tree"]
    assert tbake.to_markdown(results) == jbake.to_markdown(results)


@pytest.mark.parametrize("name", ["sift", "dummy", "colmap_sift", "vit", "hybrid",
                                  "trainable_vit", "trainable_vit_trained",
                                  "trainable_vit_finetuned", "vit_finetuned"])
def test_weights_label_equals_jax(name):
    assert tbake._weights_label(name) == jbake._weights_label(name)


def test_md_only_writes_the_jax_markdown(tmp_path, fixed_clock, capsys):
    results = _small_results(3, "same", True)
    (tmp_path / "QUALITY.json").write_text(json.dumps(results))
    tbake.main(["--md-only", "--work-dir", str(tmp_path)])
    assert (tmp_path / "QUALITY.md").read_text() == jbake.to_markdown(results)
    assert "## HPatches protocol" in capsys.readouterr().out


def _defaults(parser) -> dict:
    return {a.dest: a.default for a in parser._actions
            if not isinstance(a, argparse._HelpAction)}


def test_defaults_and_flags_match_jax(monkeypatch):
    """The JAX script's flags with their defaults (its parser caught at
    ``parse_args``), plus --weights and --device, and the work directory
    moved off the TPU's results."""
    caught = {}

    def catch(parser, *a, **kw):
        caught["parser"] = parser
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    with pytest.raises(SystemExit):
        jbake.main()
    monkeypatch.undo()
    ref = _defaults(caught["parser"])
    ours = _defaults(tbake.build_argparser())
    assert ref.pop("work_dir") == Path("results/quality")
    assert ours.pop("work_dir") == Path("results/quality_torch")
    assert ours.pop("weights") is None and ours.pop("device") is None
    assert ours == ref


@pytest.fixture
def tiny_backbone(monkeypatch):
    monkeypatch.setitem(tdino.VIT_CONFIGS, "tiny", TINY)


def _random_tiny(path):
    g = torch.Generator().manual_seed(5)
    model, _ = make_backbone("tiny", generator=g)
    with torch.no_grad():
        for key, value in model.state_dict().items():
            if key.endswith(".gamma"):
                value.fill_(0.1)
            elif "norm" in key and key.endswith(".bias"):
                value.copy_(0.1 * torch.randn(value.shape, generator=g))
    torch.save(model.state_dict(), path)
    return path


def test_small_run_writes_every_row_and_keeps_earlier_ones(tmp_path, tiny_backbone):
    work = tmp_path / "q"
    first = tbake.main(["--work-dir", str(work), "--extractors", "sift", "--skip-recon",
                        *SMALL])
    assert set(first["hpatches"]) == set(first["hpatches_holdout"]) == {"sift"}
    assert first["meta"]["device"] == "cpu" and first["reconstruction"] == {}
    res = tbake.main(["--work-dir", str(work), "--extractors", "dummy", *SMALL])
    saved = json.loads((work / "QUALITY.json").read_text())
    assert saved == json.loads(json.dumps(res))
    assert set(saved["hpatches"]) == set(saved["hpatches_holdout"]) == {"sift", "dummy"}
    assert saved["hpatches"]["sift"] == json.loads(json.dumps(first["hpatches"]["sift"]))
    assert set(saved["reconstruction"]) == {"dummy"}
    assert "| dummy | n/a (no model) |" in (work / "QUALITY.md").read_text()
    assert (work / "scene" / "images" / "gt_poses.json").exists()
    # The held-out tree is the one the JAX script's builder writes.
    args = argparse.Namespace(n_illum=1, n_view=1, n_img=3, height=126, width=168)
    ref = jbake.build_holdout(tmp_path / "jax", args)
    files = sorted(f.relative_to(ref) for f in ref.rglob("*") if f.is_file())
    assert files == sorted(f.relative_to(work / "hpatches_holdout")
                           for f in (work / "hpatches_holdout").rglob("*") if f.is_file())
    for f in files:  # bounds of tests/test_torch_training_geometry.py
        a, b = ref / f, work / "hpatches_holdout" / f
        if f.name.startswith("H_"):
            np.testing.assert_array_equal(np.loadtxt(b), np.loadtxt(a))
        else:
            d = np.abs(imread_rgb(b).astype(int) - imread_rgb(a).astype(int))
            assert d.shape == (126, 168, 3) and d.mean() <= 2.0, (f, d.mean())


def test_small_trained_run_loads_its_checkpoint(tmp_path, tiny_backbone, monkeypatch):
    from vit_colmap_tpu_torch.features import trainable_vit_extractor as ttve

    weights = _random_tiny(tmp_path / "tiny.pth")
    loaded = []
    real = ttve.TrainableViTExtractor._load_checkpoint
    monkeypatch.setattr(ttve.TrainableViTExtractor, "_load_checkpoint",
                        lambda self, path: (loaded.append(path), real(self, path))[1])
    work = tmp_path / "q"
    res = tbake.main(["--work-dir", str(work), "--extractors", "trainable_vit", "--train",
                      "--skip-recon", "--weights", str(weights), *SMALL])
    row = "trainable_vit_trained"
    assert set(res["hpatches"]) == {"trainable_vit", row}
    assert res["hpatches"][row]["weights_label"] == "trained heads, RANDOM backbone"
    trained = work / "checkpoints" / "best_model"
    combined = work / f"weights_{row}"
    assert str(combined) in loaded and str(work / "weights_trainable_vit") in loaded
    ours, ref = load_checkpoint(combined), load_checkpoint(trained)
    assert ours["heads"].keys() == ref["heads"].keys()
    assert all(torch.equal(ours["heads"][k], ref["heads"][k]) for k in ref["heads"])
    backbone = torch.load(weights, weights_only=True)
    assert all(torch.equal(ours["backbone"][k], backbone[k]) for k in backbone)


def test_raises_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tbake.main(["--work-dir", str(tmp_path), "--fast"])
    assert not (tmp_path / "QUALITY.json").exists()
