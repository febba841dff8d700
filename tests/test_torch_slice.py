"""The port's first slice end to end against the JAX package: ViTExtractor
.extract -> COLMAP database -> match_exhaustive (no verification), on three
small patch-aligned PNGs, with a tiny backbone (depth 2, embed 128, 2
heads) carried from flax by ``jax_dinov2_to_torch``, the same PCA file,
fp32 and eager attention.

Bounds: keypoints within 1e-3 px, descriptors within +-1, identical matches.
"""

import sqlite3

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_colmap_tpu.database import ColmapDatabase as JaxDatabase
from vit_colmap_tpu.features.vit_extractor import ViTExtractor as JaxViTExtractor
from vit_colmap_tpu.models import dinov2 as jdino
from vit_colmap_tpu.pipeline.match import match_exhaustive as jax_match_exhaustive
from vit_colmap_tpu.utils.config import MatchingConfig as JaxMatchingConfig
from vit_colmap_tpu_torch.database import ColmapDatabase
from vit_colmap_tpu_torch.features.vit_extractor import ViTExtractor
from vit_colmap_tpu_torch.models import dinov2 as tdino
from vit_colmap_tpu_torch.models.convert import jax_dinov2_to_torch
from vit_colmap_tpu_torch.pipeline import Pipeline
from vit_colmap_tpu_torch.pipeline.match import match_exhaustive
from vit_colmap_tpu_torch.utils.config import Config, MatchingConfig
from vit_colmap_tpu_torch.utils.image_io import write_png

TINY = dict(embed_dim=128, depth=2, num_heads=2, mlp_ratio=4.0, swiglu=False)


@pytest.fixture
def tiny_backbone(monkeypatch):
    monkeypatch.setitem(jdino.VIT_CONFIGS, "tiny", TINY)
    monkeypatch.setitem(tdino.VIT_CONFIGS, "tiny", TINY)


@pytest.fixture
def images(tmp_path):
    """Three 140 x 196 views of one random scene, shifted by whole patches."""
    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, (24, 36, 3), dtype=np.uint8)
    d = tmp_path / "images"
    d.mkdir()
    for i in range(3):
        view = np.roll(base, 2 * i, axis=1)[:20, :28]
        write_png(d / f"view_{i}.png", np.kron(view, np.ones((7, 7, 1), np.uint8)))
    return d


def _rows(db_path, table):
    con = sqlite3.connect(db_path)
    try:
        return con.execute(f"SELECT * FROM {table} ORDER BY 1").fetchall()
    finally:
        con.close()


def _extractors(tmp_path):
    kw = dict(backbone="tiny", max_keypoints=128, image_batch=2,
              pca_path=str(tmp_path / "pca.npz"), attn_impl="xla")
    jex = JaxViTExtractor(dtype=jnp.float32, **kw)
    # Flax's init (LayerScale 1e-5, unit/zero LayerNorms, zero cls) makes the
    # channel mean of the final LayerNorm's output, the saliency input, pure
    # rounding noise; give every parameter a visible random value.
    rng = np.random.default_rng(1)
    jex.params = jax.tree_util.tree_map(
        lambda p: jnp.asarray(
            np.asarray(p) + 0.3 * rng.standard_normal(p.shape).astype(np.float32)
        ),
        jex.params,
    )
    tex = ViTExtractor(dtype=torch.float32, device="cpu", **kw)
    tex.model.load_state_dict(jax_dinov2_to_torch(jex.params))
    return jex, tex


def test_slice_matches_jax(tmp_path, tiny_backbone, images):
    jex, tex = _extractors(tmp_path)
    jdb, tdb = tmp_path / "jax.db", tmp_path / "torch.db"
    jex.extract(images, jdb, "SIMPLE_PINHOLE")  # fits and saves the PCA
    tex._pca = None
    tex._ensure_pca([])  # loads the same PCA file
    tex.extract(images, tdb, "SIMPLE_PINHOLE")

    assert _rows(jdb, "cameras") == _rows(tdb, "cameras")
    assert _rows(jdb, "images") == _rows(tdb, "images")
    with JaxDatabase.open_database(jdb) as a, ColmapDatabase.open_database(tdb) as b:
        ids = sorted(a.read_images())
        for i in ids:
            ka, kb = a.read_keypoints(i), b.read_keypoints(i)
            assert ka.shape == kb.shape and len(ka) > 0
            np.testing.assert_allclose(kb, ka, atol=1e-3)
            da, db_ = a.read_descriptors(i), b.read_descriptors(i)
            assert np.abs(da.astype(int) - db_.astype(int)).max() <= 1

    mcfg = dict(do_verification=False, descriptor_encoding="signed", pair_batch=2)
    jstats = jax_match_exhaustive(jdb, JaxMatchingConfig(**mcfg),
                                  device_descriptors=jex.device_cache)
    tstats = match_exhaustive(tdb, MatchingConfig(**mcfg),
                              device_descriptors=tex.device_cache, device="cpu")
    assert tstats.num_pairs == jstats.num_pairs == 3
    assert tstats.total_matches == jstats.total_matches > 0
    assert _rows(jdb, "matches") == _rows(tdb, "matches")


def test_pipeline_without_cross_check_matches_jax(tmp_path, tiny_backbone, images,
                                                 monkeypatch):
    """``Pipeline.run`` with ``MatchingConfig.cross_check=False`` (kernel 4's
    path) in both packages, each on the extractor pair of the slice test:
    the same matches in the database."""
    from vit_colmap_tpu.pipeline import Pipeline as JaxPipeline
    from vit_colmap_tpu.utils.config import Config as JaxConfig

    jex, tex = _extractors(tmp_path)
    jex.extract(images, tmp_path / "fit.db", "SIMPLE_PINHOLE")  # saves the PCA
    tex._pca = None
    tex._ensure_pca([])
    dbs = {}
    for name, pipe_cls, cfg_cls, ex, kw in (
        ("jax", JaxPipeline, JaxConfig, jex, {}),
        ("torch", Pipeline, Config, tex, {"device": "cpu"}),
    ):
        cfg = cfg_cls()
        cfg.matching.cross_check = False
        cfg.matching.do_verification = False
        cfg.do_reconstruction = False
        pipe = pipe_cls(cfg, **kw)
        monkeypatch.setattr(pipe, "_make_extractor", lambda ex=ex: ex)
        dbs[name] = tmp_path / f"{name}_pipe.db"
        pipe.run(images, tmp_path / f"{name}_out", dbs[name])
    matches = _rows(dbs["torch"], "matches")
    assert matches == _rows(dbs["jax"], "matches") and len(matches) > 0
    cross = tmp_path / "cross.db"
    tex.extract(images, cross, "SIMPLE_PINHOLE")
    match_exhaustive(cross, MatchingConfig(do_verification=False,
                                           descriptor_encoding="signed"),
                     device_descriptors=tex.device_cache, device="cpu")
    n_cross = sum(r[1] for r in _rows(cross, "matches"))  # rows per pair
    assert n_cross < sum(r[1] for r in matches)  # the check removes some


def test_match_from_database_equals_device_handoff(tmp_path, tiny_backbone, images):
    _, tex = _extractors(tmp_path)
    db = tmp_path / "t.db"
    tex.extract(images, db, "SIMPLE_PINHOLE")
    cfg = MatchingConfig(do_verification=False, descriptor_encoding="signed")
    match_exhaustive(db, cfg, device_descriptors=tex.device_cache, device="cpu")
    handoff = _rows(db, "matches")
    match_exhaustive(db, cfg, device="cpu")
    assert _rows(db, "matches") == handoff and len(handoff) > 0


def test_pipeline_cli_runs_slice_on_cpu(tmp_path, tiny_backbone, images):
    from vit_colmap_tpu_torch.pipeline.run_pipeline import main

    db = tmp_path / "cli.db"
    main(["--images", str(images), "--output", str(tmp_path / "out"),
          "--db", str(db), "--extractor", "vit", "--backbone", "tiny",
          "--max-keypoints", "64", "--skip-verification",
          "--skip-reconstruction", "--device", "cpu"])
    with ColmapDatabase.open_database(db) as d:
        assert d.num_images == 3 and d.num_keypoints > 0 and d.num_matches > 0


@pytest.mark.parametrize("skip", [(), ("verification",), ("reconstruction",)])
def test_unported_stages_raise(tmp_path, images, skip):
    cfg = Config()
    cfg.matching.do_verification = "verification" not in skip
    cfg.do_reconstruction = "reconstruction" not in skip
    with pytest.raises(NotImplementedError, match="not ported yet"):
        Pipeline(cfg, device="cpu").run(images, tmp_path / "o", tmp_path / "d.db")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        match_exhaustive(tmp_path / "d.db", MatchingConfig(), device="cpu")


def test_cuda_is_the_default_device(monkeypatch):
    from vit_colmap_tpu_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError):
        Pipeline(Config())
    assert resolve_device("cpu").type == "cpu"


def test_database_blobs_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    kp = rng.random((5, 2)).astype(np.float32)
    desc = rng.integers(0, 256, (5, 128), dtype=np.uint8)
    m = np.array([[0, 1], [2, 3]], np.uint32)
    for cls, name in ((JaxDatabase, "j.db"), (ColmapDatabase, "t.db")):
        db = cls(tmp_path / name)
        cam = db.add_camera("SIMPLE_PINHOLE", 10, 8, [10.0, 5.0, 4.0])
        a, b = db.add_image("a.png", cam), db.add_image("b.png", cam)
        db.add_keypoints(a, kp)
        db.add_descriptors(a, desc)
        db.add_matches(b, a, m)  # swapped ids: blob columns swap too
        db.close()
    for table in ("cameras", "images", "keypoints", "descriptors", "matches"):
        assert _rows(tmp_path / "j.db", table) == _rows(tmp_path / "t.db", table)


def test_public_checkpoint_layout_loads(tmp_path, tiny_backbone):
    """A DINOv2 state dict saved by torch, wrapped and with the public
    checkpoints' extra mask_token, loads into the extractor."""
    model, _ = tdino.make_backbone("tiny", dtype=torch.float32,
                                   generator=torch.Generator().manual_seed(3))
    sd = dict(model.state_dict(), mask_token=torch.zeros(1, 128))
    torch.save({"model": sd}, tmp_path / "w.pth")
    ex = ViTExtractor(weights_path=str(tmp_path / "w.pth"), backbone="tiny",
                      dtype=torch.float32, device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(ex.model.state_dict()[k], v)
    del sd["norm.weight"]
    torch.save(sd, tmp_path / "bad.pth")
    with pytest.raises(ValueError, match="lacks backbone keys"):
        ViTExtractor(weights_path=str(tmp_path / "bad.pth"), backbone="tiny",
                     device="cpu")


def test_extract_batch_matches_jax(tmp_path, tiny_backbone):
    """The raw batch API: the same (xy, scores, valid, desc_u8, f32 desc)."""
    jex, tex = _extractors(tmp_path)
    jex.emit_float_desc = tex.emit_float_desc = True
    rng = np.random.default_rng(4)
    imgs = rng.integers(0, 256, (2, 70, 98, 3), dtype=np.uint8)
    ref = [np.asarray(a) for a in jex.extract_batch(imgs)]  # fits the PCA
    comps, mean = (torch.from_numpy(np.array(a)) for a in jex._pca)
    tex._pca = (comps, mean)
    out = tex.extract_batch(imgs)
    assert [o.shape for o in out] == [r.shape for r in ref]
    np.testing.assert_allclose(out[0], ref[0], atol=1e-4)
    np.testing.assert_allclose(out[1], ref[1], atol=1e-5)
    np.testing.assert_array_equal(out[2], ref[2])
    assert np.abs(out[3].astype(int) - ref[3].astype(int)).max() <= 1
    np.testing.assert_allclose(out[4], ref[4], atol=1e-2)
