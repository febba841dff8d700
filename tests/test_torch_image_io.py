"""Image decoding and INTER_AREA resizing of the PyTorch port (stdlib +
numpy) against OpenCV, within +-1."""

import struct
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest

from vit_colmap_tpu_torch.utils import image_io

SCENE_IMAGE = (Path(__file__).resolve().parent.parent
               / "results/quality/scene/images/view_000.png")


def _cv2_rgb(path):
    return cv2.cvtColor(cv2.imread(str(path)), cv2.COLOR_BGR2RGB)


def _png(img: np.ndarray, filters) -> bytes:
    """Encode (H, W, C) uint8 with the given per-row PNG filter cycle."""
    h, w, c = img.shape
    x = img.astype(np.int32).reshape(h, w * c)
    prev = np.zeros(w * c, np.int32)
    rows = []
    for r in range(h):
        cur, ft = x[r], filters[r % len(filters)]
        a = np.concatenate([np.zeros(c, np.int32), cur[:-c]])
        ul = np.concatenate([np.zeros(c, np.int32), prev[:-c]])
        p = a + prev - ul
        pa, pb, pc = abs(p - a), abs(p - prev), abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, ul))
        pred = [0, a, prev, (a + prev) >> 1, paeth][ft]
        rows.append(bytes([ft]) + ((cur - pred) & 255).astype(np.uint8).tobytes())
        prev = cur

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    color = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    return (image_io.PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


def test_png_matches_cv2_on_scene_image():
    out = image_io.imread_rgb(SCENE_IMAGE)
    np.testing.assert_array_equal(out, _cv2_rgb(SCENE_IMAGE))


@pytest.mark.parametrize("filters", [[0], [1], [2], [3], [4], [0, 1, 2, 3, 4]])
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_filters_and_color_types(tmp_path, filters, channels):
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (23, 31, channels), dtype=np.uint8)
    path = tmp_path / "x.png"
    path.write_bytes(_png(img, filters))
    np.testing.assert_array_equal(image_io.decode_png(path.read_bytes()), img)
    np.testing.assert_array_equal(image_io.imread_rgb(path), _cv2_rgb(path))


def test_write_png_round_trips_through_cv2(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (40, 50, 3), dtype=np.uint8)
    image_io.write_png(tmp_path / "w.png", img)
    np.testing.assert_array_equal(_cv2_rgb(tmp_path / "w.png"), img)


@pytest.mark.parametrize("magic,channels", [(b"P6", 3), (b"P5", 1)])
def test_pnm_matches_cv2(tmp_path, magic, channels):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (20, 30, channels), dtype=np.uint8)
    path = tmp_path / "x.pnm"
    path.write_bytes(magic + b"\n# comment\n30 20\n255\n" + img.tobytes())
    np.testing.assert_array_equal(image_io.imread_rgb(path), _cv2_rgb(path))


@pytest.mark.parametrize("size", [(630, 476), (476, 476), (320, 240), (14, 14)])
def test_resize_area_matches_cv2(size):
    img = _cv2_rgb(SCENE_IMAGE)
    ref = cv2.resize(img, size, interpolation=cv2.INTER_AREA)
    out = image_io.resize_area(img, *size)
    assert out.shape == ref.shape
    assert np.abs(out.astype(int) - ref.astype(int)).max() <= 1


@pytest.mark.parametrize("size", [(154, 112), (70, 56), (60, 100), (126, 30), (1596, 1190)])
def test_resize_area_grows_as_cv2(size):
    """An axis that grows takes OpenCV's bilinear path with area
    coefficients: the same bytes."""
    img = np.random.default_rng(size[0]).integers(0, 256, (45, 70, 3), dtype=np.uint8)
    if size == (1596, 1190):
        img = _cv2_rgb(SCENE_IMAGE)
    ref = cv2.resize(img, size, interpolation=cv2.INTER_AREA)
    np.testing.assert_array_equal(image_io.resize_area(img, *size), ref)


def test_unsupported_formats_raise(tmp_path, monkeypatch):
    jpg = tmp_path / "x.jpg"
    ok, buf = cv2.imencode(".jpg", np.zeros((8, 8, 3), np.uint8))
    jpg.write_bytes(buf.tobytes())
    bmp = tmp_path / "x.bmp"
    ok, buf = cv2.imencode(".bmp", np.zeros((8, 8, 3), np.uint8))
    bmp.write_bytes(buf.tobytes())
    with pytest.raises(NotImplementedError):
        image_io.imread_rgb(bmp)
    # JPEG decodes through the native host decoder; without it, it raises.
    from vit_colmap_tpu_torch.utils import native_io

    monkeypatch.setattr(native_io, "load_native", lambda: None)
    with pytest.raises(NotImplementedError):
        image_io.imread_rgb(jpg)
    data = bytearray(_png(np.zeros((4, 4, 3), np.uint8), [0]))
    data[28] = 1  # interlace method byte of IHDR
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
    with pytest.raises(NotImplementedError):
        image_io.decode_png(bytes(data))
    with pytest.raises(ValueError):
        image_io.decode_png(bytes(data[:40]) + b"\0" * 8)
