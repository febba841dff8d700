"""``Pipeline.run(extractor_type="trainable_vit")`` of the port against the
JAX package's, and the CLI with ``--extractor trainable_vit`` and
``--profile-dir``, on the CPU.

Both pipelines load one reference-layout ``.pt`` (heads with BatchNorms and
an embedded tiny DINOv2: depth 2, embed 128, 2 heads) and run their
extractors in f32, on three 140 x 196 views of one random scene shifted by
whole patches, with the reference's SfM budget rule (``sfm_max_keypoints``
256), verification and reconstruction off (the JAX package compiles its
RANSAC programs for minutes on the CPU; ``tests/test_torch_verify.py``
holds verification).  Bounds: the same images and keypoint counts; on each
pair the port's matches equal the JAX package's for at least 95% of the
JAX package's rows, a match being the two keypoints it joins (their
positions to 0.01 px: keypoints whose scores tie to float rounding may take
each other's ranks, and so each other's row numbers); signed descriptors;
the report's keys.
"""

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_trainable_extractor import TINY, _reference_checkpoint
from vit_colmap_tpu.database import ColmapDatabase as JaxDatabase
from vit_colmap_tpu.features import trainable_vit_extractor as jtve
from vit_colmap_tpu.models import dinov2 as jdino
from vit_colmap_tpu.pipeline import Pipeline as JaxPipeline
from vit_colmap_tpu.utils.config import Config as JaxConfig
from vit_colmap_tpu_torch.database import ColmapDatabase
from vit_colmap_tpu_torch.features import trainable_vit_extractor as ttve
from vit_colmap_tpu_torch.models import dinov2 as tdino
from vit_colmap_tpu_torch.pipeline import Pipeline
from vit_colmap_tpu_torch.utils.config import Config
from vit_colmap_tpu_torch.utils.image_io import write_png

ROOT = Path(__file__).resolve().parent.parent


def _write_views(d: Path) -> None:
    """Three 140 x 196 views of one random scene, shifted by whole patches."""
    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, (24, 36, 3), dtype=np.uint8)
    d.mkdir(parents=True)
    for i in range(3):
        view = np.roll(base, 2 * i, axis=1)[:20, :28]
        write_png(d / f"view_{i}.png", np.kron(view, np.ones((7, 7, 1), np.uint8)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("trainable_pipeline")
    _write_views(work / "images")
    weights = work / "heads.pt"
    _reference_checkpoint(weights, "model_state_dict", "_orig_mod.", seed=2)
    mp = pytest.MonkeyPatch()
    mp.setitem(jdino.VIT_CONFIGS, "tiny", TINY)
    mp.setitem(tdino.VIT_CONFIGS, "tiny", TINY)
    # f32 extractors in both packages, so that the comparison is not bf16's.
    mp.setattr(jtve, "TrainableViTExtractor",
               functools.partial(jtve.TrainableViTExtractor, dtype=jnp.float32))
    mp.setattr(ttve, "TrainableViTExtractor",
               functools.partial(ttve.TrainableViTExtractor, dtype=torch.float32))
    threads = torch.get_num_threads()
    torch.set_num_threads(2)  # the test workers share the machine's cores
    out = {}
    try:
        for name, pipe_cls, cfg_cls, kw in (("jax", JaxPipeline, JaxConfig, {}),
                                            ("torch", Pipeline, Config, {"device": "cpu"})):
            cfg = cfg_cls()
            cfg.extractor.extractor_type = "trainable_vit"
            cfg.extractor.backbone = "tiny"
            cfg.extractor.vit_weights_path = str(weights)
            cfg.extractor.sfm_max_keypoints = 256
            cfg.matching.pair_batch = 2
            cfg.matching.do_verification = False
            cfg.do_reconstruction = False
            pipe = pipe_cls(cfg, **kw)
            report = pipe.run(work / "images", work / name, work / f"{name}.db")
            out[name] = (pipe, report, work / f"{name}.db")
    finally:
        torch.set_num_threads(threads)
        mp.undo()
    return out


def test_pipeline_matches_jax(runs):
    (jpipe, jreport, jdb), (tpipe, treport, tdb) = runs["jax"], runs["torch"]
    assert treport["num_images"] == jreport["num_images"] == 3
    assert set(jreport) <= set(treport)
    assert tpipe.config.matching.descriptor_encoding == "signed"
    assert jpipe.config.matching.descriptor_encoding == "signed"
    extractor = next(iter(tpipe._extractors.values()))
    assert extractor.num_keypoints == 256 and extractor.detection_threshold == 0.4
    with JaxDatabase.open_database(jdb) as a, ColmapDatabase.open_database(tdb) as b:
        ids = sorted(a.read_images())
        assert ids == sorted(b.read_images())
        kpts = {}
        for i in ids:
            ka, kb = a.read_keypoints(i), b.read_keypoints(i)
            assert kb.shape == ka.shape and kb.shape[1] == 6 and 0 < len(kb) <= 256
            kpts[i] = ka, kb
        for i, j in [(i, j) for i in ids for j in ids if i < j]:
            ma, mb = a.read_matches(i, j), b.read_matches(i, j)
            assert ma is not None and len(ma) > 0, (i, j)
            joined_a = _joined(ma, kpts[i][0], kpts[j][0])
            joined_b = set() if mb is None else _joined(mb, kpts[i][1], kpts[j][1])
            assert len(joined_a & joined_b) >= 0.95 * len(joined_a), (i, j)


def _joined(matches, k1, k2) -> set:
    """Each match as the positions (to 0.01 px) of the keypoints it joins."""
    p1 = np.round(k1[matches[:, 0], :2], 2)
    p2 = np.round(k2[matches[:, 1], :2], 2)
    return {tuple(r) for r in np.concatenate([p1, p2], axis=1).tolist()}


def _cli(args, **kw):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, "-m", "vit_colmap_tpu_torch.pipeline", *args],
                          cwd=ROOT, capture_output=True, text=True, timeout=600, env=env,
                          **kw)


def test_cli_trainable_vit_with_profile_dir(tmp_path):
    """The CLI runs the trainable extractor (vits14, random heads) on the
    CPU when asked, writes 6-column keypoints, logs the three stages'
    timings and writes a torch.profiler trace into --profile-dir; without
    --device it needs CUDA."""
    _write_views(tmp_path / "images")
    out = tmp_path / "out"
    args = ["--images", str(tmp_path / "images"), "--output", str(out), "--db",
            str(out / "db.db"), "--extractor", "trainable_vit", "--backbone", "vits14",
            "--sfm-max-keypoints", "128", "--profile-dir", str(tmp_path / "prof")]
    proc = _cli(args + ["--device", "cpu"])
    assert proc.returncode == 0, proc.stderr[-3000:]
    with ColmapDatabase.open_database(out / "db.db") as db:
        assert db.num_images == 3
        k = db.read_keypoints(sorted(db.read_images())[0])
        assert k.shape[1] == 6 and 0 < len(k) <= 128
    table = proc.stderr[proc.stderr.index("Stage timings:"):]
    for stage in ("extract", "match+verify", "reconstruction"):
        assert f"  {stage} " in table, table
    traces = list((tmp_path / "prof").glob("trace_*.json"))
    assert len(traces) == 1
    assert json.loads(traces[0].read_text())["traceEvents"]
    if not torch.cuda.is_available():
        proc = _cli(args)
        assert proc.returncode != 0 and "CUDA is not available" in proc.stderr


def test_hybrid_still_raises(tmp_path):
    """Every extractor is ported, the hybrid included: only an unknown
    extractor type raises, before any stage runs and without a database."""
    cfg = Config()
    cfg.extractor.extractor_type = "hybrid_vit"
    with pytest.raises(ValueError, match="Unknown extractor type"):
        Pipeline(cfg, device="cpu").run(tmp_path, tmp_path / "out", tmp_path / "db.db")
    assert not (tmp_path / "db.db").exists()
