"""The port's HybridExtractor against the JAX package's on the CPU.

The JAX hybrid detects with OpenCV on the host; the port detects with
``ops/cv_detectors.py``.  Weights are carried from flax with
``jax_dinov2_to_torch`` (ViT-S/14, f32 on both sides), both extractors share
one PCA file, and the images are ``tests/test_extractors.py``'s.

Bounds: FAST and GFTT keypoints equal and descriptors within 1 LSB (99% of
bytes exact); SIFT keypoint counts within 2%, 95% of the points within
0.05 px both ways, descriptors within 1 LSB on matched rows.  ``describe``
alone on one feature map, grid and PCA: within 1 LSB, 99% of bytes exact.
"""

import types

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_colmap_tpu.database import ColmapDatabase as JaxDatabase
from vit_colmap_tpu.features.hybrid_extractor import HybridExtractor as JaxHybrid
from vit_colmap_tpu.features.hybrid_extractor import rootsift_normalize as jax_rootsift
from vit_colmap_tpu.ops.interpolate import fit_pca as jax_fit_pca
from vit_colmap_tpu_torch.database import ColmapDatabase
from vit_colmap_tpu_torch.features.hybrid_extractor import HybridExtractor, rootsift_normalize
from vit_colmap_tpu_torch.models.convert import jax_dinov2_to_torch
from vit_colmap_tpu_torch.pipeline import Pipeline
from vit_colmap_tpu_torch.training.checkpoint import save_checkpoint
from vit_colmap_tpu_torch.utils.config import Config

torch.set_num_threads(2)

KP_TOL = 0.05
KP_SHARE = 0.95
COUNT_REL = 0.02
EXACT_SHARE = 0.99


def _write_images(d):
    """tests/test_extractors.py's two 84 x 98 views, 3 px apart."""
    d.mkdir()
    rng = np.random.default_rng(0)
    base = rng.integers(40, 215, (84, 98, 3), dtype=np.uint8)
    base = cv2.GaussianBlur(base, (0, 0), 1.5)
    yy, xx = np.mgrid[0:84, 0:98]
    base[..., 1] = ((xx // 14 + yy // 14) % 2 * 120 + 60).astype(np.uint8)
    for i in range(2):
        M = np.float32([[1, 0, i * 3], [0, 1, 0]])
        cv2.imwrite(str(d / f"im{i}.png"), cv2.warpAffine(base, M, (98, 84)))
    return d


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """One JAX ViT-S/14 hybrid (its random init), its weights as a .pth and
    the image directory."""
    root = tmp_path_factory.mktemp("hybrid")
    jex = JaxHybrid(backbone="vits14", max_keypoints=128, image_batch=2, dtype=jnp.float32)
    weights = root / "vits14.pth"
    torch.save(jax_dinov2_to_torch(jex.params), weights)
    return types.SimpleNamespace(jex=jex, weights=weights, images=_write_images(root / "imgs"),
                                 root=root)


def _rows_by_order(db_cls, path):
    db = db_cls(path)
    try:
        return [(db.read_keypoints(i), db.read_descriptors(i)) for i in sorted(db.read_images())]
    finally:
        db.close()


def _assert_bytes_close(a, b):
    a, b = a.astype(np.int32), b.astype(np.int32)
    assert a.shape == b.shape
    assert np.abs(a - b).max(initial=0) <= 1
    assert (a == b).mean() >= EXACT_SHARE if a.size else True


def test_rootsift_matches_jax():
    d = np.random.default_rng(1).standard_normal((10, 64)).astype(np.float32)
    d[3] = 0.0
    ref = np.asarray(jax_rootsift(jnp.asarray(d)))
    out = rootsift_normalize(torch.from_numpy(d)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6)


def test_describe_matches_jax():
    rng = np.random.default_rng(2)
    fmap = rng.standard_normal((2, 6, 7, 64)).astype(np.float32)
    grid = rng.uniform(-0.5, 6.5, (2, 50, 2)).astype(np.float32)
    comps, mean = (np.asarray(a) for a in jax_fit_pca(jnp.asarray(fmap.reshape(-1, 64)), 32))
    ref = JaxHybrid.describe(types.SimpleNamespace(_pca=(jnp.asarray(comps), jnp.asarray(mean))),
                             jnp.asarray(fmap), grid)
    ex = HybridExtractor.__new__(HybridExtractor)
    ex.device = torch.device("cpu")
    ex.set_pca(comps, mean)
    out = ex.describe(torch.from_numpy(fmap), grid)
    assert out.dtype == np.uint8
    _assert_bytes_close(out, np.asarray(ref))


def _run_both(shared, detector, tmp_path):
    jex = shared.jex
    jex.detector_name = detector
    pca = shared.root / "pca.npz"
    jex.pca_path = str(pca)
    jex._pca = None
    jex.extract(shared.images, tmp_path / "jax.db", "SIMPLE_PINHOLE")
    tex = HybridExtractor(weights_path=str(shared.weights), backbone="vits14", detector=detector,
                          max_keypoints=128, image_batch=2, dtype=torch.float32,
                          pca_path=str(pca), device="cpu")
    tex.extract(shared.images, tmp_path / "port.db", "SIMPLE_PINHOLE")
    return (_rows_by_order(JaxDatabase, tmp_path / "jax.db"),
            _rows_by_order(ColmapDatabase, tmp_path / "port.db"))


@pytest.mark.parametrize("detector", ["fast", "gftt"])
def test_extract_matches_jax_exact_detectors(shared, detector, tmp_path):
    ref, out = _run_both(shared, detector, tmp_path)
    assert len(ref) == len(out) == 2
    for (rk, rd), (k, d) in zip(ref, out):
        assert len(rk) > 0
        np.testing.assert_array_equal(k, rk)
        _assert_bytes_close(d, rd)


def test_extract_matches_jax_sift(shared, tmp_path):
    from scipy.spatial import cKDTree

    ref, out = _run_both(shared, "sift", tmp_path)
    for (rk, rd), (k, d) in zip(ref, out):
        assert len(rk) > 0
        assert abs(len(k) - len(rk)) <= COUNT_REL * len(rk)
        dist, idx = cKDTree(k).query(rk)
        assert (dist <= KP_TOL).mean() >= KP_SHARE
        assert (cKDTree(rk).query(k)[0] <= KP_TOL).mean() >= KP_SHARE
        near = dist <= KP_TOL
        diff = np.abs(d[idx[near]].astype(np.int32) - rd[near].astype(np.int32))
        # matched rows of equal points: within 1 LSB (a repeated point's
        # rows are equal, so the nearest of them is as good as its own)
        assert diff.max(initial=0) <= 1


def test_unknown_detector_raises():
    with pytest.raises(ValueError, match="Unknown detector"):
        HybridExtractor(backbone="vits14", detector="surf", device="cpu")


def _shifted_views(d, n=3):
    """Crops of one structured image 14 px (one patch) apart: random-weight
    tokens match across whole-patch shifts."""
    from vit_colmap_tpu_torch.dataloader.synthetic_benchmark import make_structured_image
    from vit_colmap_tpu_torch.utils.image_io import write_png

    d.mkdir()
    base = make_structured_image(np.random.default_rng(3), 112, 140 + 14 * n)
    for i in range(n):
        write_png(d / f"view_{i}.png", base[:, 14 * i : 14 * i + 140])
    return d


def test_pipeline_and_cli_run_hybrid(shared, tmp_path):
    from vit_colmap_tpu_torch.pipeline.run_pipeline import main

    images = _shifted_views(tmp_path / "views")
    cfg = Config()
    cfg.extractor.extractor_type = "hybrid"
    cfg.extractor.backbone = "vits14"
    cfg.extractor.vit_weights_path = str(shared.weights)
    cfg.extractor.max_keypoints = 128
    cfg.do_reconstruction = False
    cfg.matching.do_verification = False
    Pipeline(cfg, device="cpu").run(images, tmp_path / "o", tmp_path / "p.db")
    with ColmapDatabase.open_database(tmp_path / "p.db") as db:
        assert db.num_images == 3 and db.num_matches > 0
    main(["--images", str(images), "--output", str(tmp_path / "cli"),
          "--db", str(tmp_path / "cli.db"), "--extractor", "hybrid", "--backbone", "vits14",
          "--vit-weights", str(shared.weights), "--max-keypoints", "128",
          "--skip-verification", "--skip-reconstruction", "--device", "cpu"])
    with ColmapDatabase.open_database(tmp_path / "cli.db") as db:
        assert db.num_images == 3 and db.num_matches > 0


def test_trainer_checkpoint_directory(shared, tmp_path):
    src = HybridExtractor(weights_path=str(shared.weights), backbone="vits14", device="cpu")
    heads = torch.nn.Linear(2, 2)
    save_checkpoint(tmp_path / "ck", heads, backbone=src.model)
    ex = HybridExtractor(weights_path=str(tmp_path / "ck"), backbone="vits14", seed=5,
                         device="cpu")
    for (k, a), b in zip(src.model.state_dict().items(), ex.model.state_dict().values()):
        assert torch.equal(a, b), k
    save_checkpoint(tmp_path / "heads_only", heads)
    with pytest.raises(ValueError, match="no backbone"):
        HybridExtractor(weights_path=str(tmp_path / "heads_only"), backbone="vits14",
                        device="cpu")
