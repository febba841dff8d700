"""The port's YUV420 wire formats (``vit_colmap_tpu_torch/ops/transfer.py``):
the host packers against cv2's I420 (bit for bit) and the JAX package's
packers, the device unpackers against the JAX package's (within 1e-4 of
255), and the cases of ``tests/test_transfer.py`` on the port."""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_colmap_tpu.ops import transfer as jtransfer
from vit_colmap_tpu_torch.ops.transfer import (
    i420_to_c4,
    pack_batch_yuv420,
    pack_batch_yuv420_c4,
    pack_yuv420,
    pack_yuv420_full,
    unpack_yuv420,
    unpack_yuv420_c4,
)


def _smooth(rng, h=84, w=112):
    small = rng.integers(0, 255, (h // 8, w // 8, 3), dtype=np.uint8)
    return cv2.resize(small, (w, h), interpolation=cv2.INTER_CUBIC)


def _unpack(fn, packed, **kw):
    return fn(torch.from_numpy(packed), **kw).numpy()


@pytest.mark.parametrize("shape", [(84, 112), (70, 84), (2, 2), (1190, 84)])
def test_packers_match_cv2_and_jax(shape):
    rng = np.random.default_rng(sum(shape))
    img = rng.integers(0, 256, (*shape, 3), dtype=np.uint8)
    np.testing.assert_array_equal(pack_yuv420(img), cv2.cvtColor(img, cv2.COLOR_RGB2YUV_I420))
    np.testing.assert_array_equal(pack_yuv420_full(img), jtransfer.pack_yuv420_full(img))
    for full in (False, True):
        np.testing.assert_array_equal(pack_batch_yuv420_c4(img[None], full_range=full),
                                      jtransfer.pack_batch_yuv420_c4(img[None],
                                                                     full_range=full))


@pytest.mark.parametrize("full_range", [False, True])
@pytest.mark.parametrize("shape", [(84, 112), (70, 84)])
def test_unpackers_match_jax(shape, full_range):
    rng = np.random.default_rng(7)
    imgs = rng.integers(0, 256, (2, *shape, 3), dtype=np.uint8)
    i420 = pack_batch_yuv420(imgs)
    c4 = i420_to_c4(i420)
    for fn, jfn, wire in ((unpack_yuv420, jtransfer.unpack_yuv420, i420),
                          (unpack_yuv420_c4, jtransfer.unpack_yuv420_c4, c4)):
        ref = np.asarray(jfn(jnp.asarray(wire), full_range=full_range))
        out = _unpack(fn, wire, full_range=full_range)
        assert out.shape == ref.shape == (2, *shape, 3) and out.dtype == np.float32
        np.testing.assert_allclose(out, ref, atol=1e-4 * 255)


# -- the cases of tests/test_transfer.py, on the port ------------------------


def test_roundtrip_matches_cv2_inverse():
    rng = np.random.default_rng(0)
    img = _smooth(rng)
    packed = pack_batch_yuv420(img[None])
    ours = _unpack(unpack_yuv420, packed)[0]
    cv2_back = cv2.cvtColor(packed[0], cv2.COLOR_YUV2RGB_I420).astype(np.float32)
    err_ours = np.abs(ours - img.astype(np.float32)).mean()
    err_cv2 = np.abs(cv2_back - img.astype(np.float32)).mean()
    assert err_ours <= err_cv2 + 0.5, (err_ours, err_cv2)
    assert err_ours < 8.0


def test_roundtrip_luma_near_lossless():
    rng = np.random.default_rng(1)
    gray = _smooth(rng)[..., :1].repeat(3, axis=-1)
    rec = _unpack(unpack_yuv420, pack_batch_yuv420(gray[None]))[0]
    assert np.abs(rec - gray.astype(np.float32)).mean() < 1.0


def test_odd_plane_alignment():
    img = np.zeros((70, 84, 3), np.uint8)
    img[..., 0], img[..., 1], img[..., 2] = 200, 50, 120
    packed = pack_batch_yuv420(img[None])
    ours = _unpack(unpack_yuv420, packed)[0]
    cv2_back = cv2.cvtColor(packed[0], cv2.COLOR_YUV2RGB_I420).astype(np.float32)
    assert np.abs(ours - cv2_back).max() < 1.0


def test_c4_wire_size():
    rng = np.random.default_rng(2)
    for h, w in ((84, 112), (70, 84), (1190, 84)):
        packed = pack_batch_yuv420_c4(_smooth(rng, h=h, w=w)[None])
        assert packed.shape == (1, h + (h + 3) // 4, w) and packed.dtype == np.uint8


def test_c4_roundtrip_close_to_i420():
    rng = np.random.default_rng(0)
    i420 = pack_batch_yuv420(_smooth(rng)[None])
    base = _unpack(unpack_yuv420, i420)[0]
    ours = _unpack(unpack_yuv420_c4, i420_to_c4(i420))[0]
    diff = np.abs(ours - base)
    assert diff.mean() < 4.0, diff.mean()
    assert diff.max() <= 17.0 * 1.8, diff.max()


def test_c4_luma_untouched():
    rng = np.random.default_rng(5)
    img = _smooth(rng, h=70, w=84)
    i420 = pack_batch_yuv420(img[None])
    c4 = i420_to_c4(i420)
    np.testing.assert_array_equal(c4.reshape(1, -1)[:, :70 * 84],
                                  i420.reshape(1, -1)[:, :70 * 84])
    assert pack_batch_yuv420_c4(img[None], full_range=True).shape == c4.shape


def test_backbone_features_agree_across_formats():
    """Dense ViT-S/14 tokens (random weights) from the yuv420 and yuv420c4
    wires stay close to the rgb path's: cosine mean > 0.97, min > 0.8."""
    from vit_colmap_tpu_torch.features.vit_extractor import ViTExtractor

    img = _smooth(np.random.default_rng(3), h=70, w=84)
    fmaps = {}
    for fmt in ("rgb", "yuv420", "yuv420c4"):
        ex = ViTExtractor(backbone="vits14", max_keypoints=32, image_batch=1, seed=0,
                          transfer_format=fmt, dtype=torch.float32, attn_impl="xla",
                          device="cpu")
        fmaps[fmt] = ex.dense_features(ex.to_wire(img[None])).reshape(-1, 384).numpy()
    a = fmaps["rgb"]
    for fmt in ("yuv420", "yuv420c4"):
        b = fmaps[fmt]
        cos = (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))
        assert cos.mean() > 0.97 and cos.min() > 0.8, (fmt, cos.mean(), cos.min())
