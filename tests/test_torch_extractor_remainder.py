"""The ViT extractor's remaining methods against the JAX package's on the CPU:
``set_pca``, ``device_extract_pipelined`` and ``device_extract_looped``, on
the slice tests' tiny backbone (depth 2, embed 128) carried from flax by
``jax_dinov2_to_torch``, fp32.

Bounds: ``set_pca`` equals loading the same ``.npz`` bit for bit; the
looped checksum equals the sum of per-iteration checksums computed from
separate ``extract_batch_async`` calls to 1e-6 relative, and JAX's looped
checksum to 1e-4 relative (the slice test's bounds: scores within 1e-5,
descriptor bytes within 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_colmap_tpu.features.vit_extractor import ViTExtractor as JaxViTExtractor
from vit_colmap_tpu.models import dinov2 as jdino
from vit_colmap_tpu_torch.features.vit_extractor import ViTExtractor
from vit_colmap_tpu_torch.models import dinov2 as tdino
from vit_colmap_tpu_torch.models.convert import jax_dinov2_to_torch
from vit_colmap_tpu_torch.ops.interpolate import save_pca

torch.set_num_threads(2)

TINY = dict(embed_dim=128, depth=2, num_heads=2, mlp_ratio=4.0, swiglu=False)
REPS = 3
CHECKSUM_REL_SELF = 1e-6
CHECKSUM_REL_JAX = 1e-4


@pytest.fixture
def tiny_backbone(monkeypatch):
    monkeypatch.setitem(jdino.VIT_CONFIGS, "tiny", TINY)
    monkeypatch.setitem(tdino.VIT_CONFIGS, "tiny", TINY)


def _images(seed=4):
    return np.random.default_rng(seed).integers(0, 256, (2, 70, 98, 3), dtype=np.uint8)


def _port(**kw):
    return ViTExtractor(backbone="tiny", max_keypoints=64, image_batch=2,
                        dtype=torch.float32, attn_impl="xla", device="cpu", **kw)


def _pair():
    """A JAX extractor (its params perturbed so every value is visible, as
    in the slice test) and the port's with the same weights and PCA."""
    jex = JaxViTExtractor(backbone="tiny", max_keypoints=64, image_batch=2,
                          dtype=jnp.float32, attn_impl="xla")
    rng = np.random.default_rng(1)
    jex.params = jax.tree_util.tree_map(
        lambda p: jnp.asarray(np.asarray(p)
                              + 0.3 * rng.standard_normal(p.shape).astype(np.float32)),
        jex.params)
    jex.extract_batch(_images())  # fits the PCA
    tex = _port()
    tex.model.load_state_dict(jax_dinov2_to_torch(jex.params))
    tex.set_pca(*(np.asarray(a) for a in jex._pca))
    return jex, tex


def test_set_pca_equals_loading_npz(tmp_path):
    rng = np.random.default_rng(0)
    comps = rng.standard_normal((128, 32)).astype(np.float32)
    mean = rng.standard_normal(128).astype(np.float32)
    save_pca(tmp_path / "pca.npz", torch.from_numpy(comps), torch.from_numpy(mean))
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(tdino.VIT_CONFIGS, "tiny", TINY)
        loaded = _port(pca_path=str(tmp_path / "pca.npz"))
        installed = _port()
    installed.set_pca(comps, mean)
    for a, b in zip(loaded._pca, installed._pca):
        assert a.dtype == b.dtype == torch.float32 and a.device == b.device
        assert torch.equal(a, b)
    imgs = _images()
    for a, b in zip(loaded.extract_batch(imgs), installed.extract_batch(imgs)):
        np.testing.assert_array_equal(a, b)


def test_device_loops_need_a_pca(tiny_backbone):
    ex = _port()
    staged = torch.from_numpy(_images())
    with pytest.raises(RuntimeError, match="fit PCA"):
        ex.device_extract_pipelined(staged, 1)
    with pytest.raises(RuntimeError, match="fit PCA"):
        ex.device_extract_looped(staged, 1)


def test_device_extract_pipelined_leaves_outputs_unchanged(tiny_backbone):
    _, ex = _pair()
    imgs = _images()
    before = ex.extract_batch(imgs)
    seconds = ex.device_extract_pipelined(torch.from_numpy(ex.to_wire(imgs)), REPS)
    assert isinstance(seconds, float) and seconds > 0
    for a, b in zip(before, ex.extract_batch(imgs)):
        np.testing.assert_array_equal(a, b)


def test_device_extract_looped_checksum(tiny_backbone):
    jex, tex = _pair()
    # JAX's looped program shards the batch over every device without
    # padding it: one image per device.
    staged = np.concatenate([_images(seed) for seed in range(max(1, jax.device_count() // 2))])
    out = tex.device_extract_looped(torch.from_numpy(staged), REPS)
    assert out.shape == () and out.dtype == torch.float32
    expected = 0.0
    for i in range(REPS):
        _, sc, _, desc = tex.extract_batch_async(
            torch.from_numpy((staged + np.uint8(i)).astype(np.uint8)), packed=True)[:4]
        expected += float(sc.sum(dtype=torch.float32)) + float(desc.sum(dtype=torch.int32))
    assert abs(float(out) - expected) <= CHECKSUM_REL_SELF * abs(expected)
    ref = float(jex.device_extract_looped(jnp.asarray(staged), REPS))
    assert abs(float(out) - ref) <= CHECKSUM_REL_JAX * abs(ref)
