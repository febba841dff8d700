"""ctypes binding of the host image decoder (``csrc/host/image_io.cc``).

Counterpart of ``vit_colmap_tpu/utils/native_io.py``: JPEG and PNG decoded
in C++ straight to I420 planes at the patch-aligned target size, the bytes
the yuv420 wire ships (:mod:`vit_colmap_tpu_torch.ops.transfer`), on
``n_threads`` threads a batch.  JPEG keeps the codec's full-range JFIF
YCbCr (no RGB pass), so the planes pair with ``unpack_yuv420(...,
full_range=True)`` on the card.

Three entry points the JAX binding lacks, because the JAX package reaches
them through ``cv2``: :func:`decode_jpeg_rgb` (``cv2.imread`` in colour,
then BGR -> RGB), :func:`decode_jpeg_gray` (``cv2.IMREAD_GRAYSCALE``, the Y
plane) and :func:`encode_jpeg` (to write test images, where no ``cv2`` is
installed).  Four more expose the JPEG decode's steps, so that the nvJPEG
route can be held to libjpeg's: :func:`decode_jpeg_ycc` (full-resolution
YCbCr), :func:`decode_jpeg_planes` (the stored planes),
:func:`upsample_ycc` and :func:`ycc_to_rgb` (libjpeg's upsampling and
colour conversion, ``csrc/host/jpeg_color.cc``).  None of them applies EXIF orientation
(``utils/image_io.imread_rgb`` does, as ``cv2.imread`` does).

The library is built with ``g++`` at first use (``kernels/host_build.py``);
its JPEG codec is libjpeg where ``libjpeg.so.62`` exists, else nvJPEG
(``host_build.jpeg_codec()`` says which).  nvJPEG decodes a batch on the
card given to :func:`decode_batch_i420`, and the other entry points on
the calling thread's current card (device 0 unless set).  ``load_native()`` returns ``None``, with
one warning giving the reason, where ``g++`` or a runtime library is
absent; callers keep their Python paths.  ``decodes`` counts the images
each entry point decoded (``"i420"``, ``"rgb"``, ``"gray"``), so a run can
show its route.
"""

from __future__ import annotations

import ctypes
import logging
from collections import Counter
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from vit_colmap_tpu_torch.kernels import host_build

logger = logging.getLogger(__name__)

decodes: Counter = Counter()
_lib = None
_lib_failed = False

_INT_P = ctypes.POINTER(ctypes.c_int)
_U8_P = ctypes.POINTER(ctypes.c_uint8)
_SIGNATURES = {
    "vc_probe": (ctypes.c_int, [ctypes.c_char_p, _INT_P, _INT_P]),
    "vc_decode_i420": (ctypes.c_int, [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, _U8_P]),
    "vc_decode_batch_i420": (ctypes.c_int, [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        _U8_P, _INT_P, ctypes.c_int, ctypes.c_int]),
    "vc_decode_jpeg_pixels": (ctypes.c_int, [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, _U8_P]),
    "vc_decode_jpeg_ycc": (ctypes.c_int, [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, _U8_P]),
    "vc_decode_jpeg_planes": (ctypes.c_int, [
        ctypes.c_char_p, _INT_P, _U8_P, _U8_P, _U8_P, ctypes.c_longlong]),
    "vc_upsample_ycc": (ctypes.c_int, [
        _U8_P, _U8_P, _U8_P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _U8_P]),
    "vc_ycc_to_rgb": (ctypes.c_int, [_U8_P, _U8_P, _U8_P, ctypes.c_longlong, _U8_P]),
    "vc_encode_jpeg": (ctypes.c_int, [
        ctypes.c_char_p, _U8_P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int]),
}


def load_native() -> Optional[ctypes.CDLL]:
    """The decoder library, built at first use; ``None`` (warning once)
    where the compiler or a runtime library is absent."""
    global _lib, _lib_failed
    if _lib is not None:
        return _lib
    if _lib_failed:
        return None
    try:
        lib = host_build.load("image_io")
    except (host_build.Unavailable, OSError) as e:
        logger.warning("Native image decoder unavailable: %s", e)
        _lib_failed = True
        return None
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    _lib = lib
    return lib


def probe_size(path: Path | str) -> Optional[tuple[int, int]]:
    """(width, height) from the image header, or None on failure."""
    lib = load_native()
    if lib is None:
        return None
    w, h = ctypes.c_int(0), ctypes.c_int(0)
    if lib.vc_probe(str(path).encode(), ctypes.byref(w), ctypes.byref(h)):
        return None
    return int(w.value), int(h.value)


def decode_batch_i420(
    paths: Sequence[Path | str],
    target_w: int,
    target_h: int,
    pad_to: Optional[int] = None,
    n_threads: int = 2,
    device: Optional[int] = None,
) -> Optional[tuple[np.ndarray, np.ndarray]]:
    """Decode and resize a batch straight into packed I420, on
    ``n_threads`` new threads; nvJPEG runs them on CUDA device ``device``
    (None: device 0), libjpeg ignores it.

    Returns ``(packed (B, th*3/2, tw) uint8, ok (B,) bool)`` where B =
    ``pad_to or len(paths)`` (extra rows zero), or None when the library is
    unavailable.  Failed images have ``ok=False`` and zero planes."""
    lib = load_native()
    if lib is None:
        return None
    n = len(paths)
    B = pad_to or n
    if n > B:
        raise ValueError(f"{n} paths do not fit pad_to={B}")
    out = np.zeros((B, target_h * 3 // 2, target_w), np.uint8)
    ok = np.zeros(B, bool)
    if n == 0:
        return out, ok
    status = np.zeros(n, np.int32)
    arr = (ctypes.c_char_p * n)(*(str(p).encode() for p in paths))
    lib.vc_decode_batch_i420(
        arr, n, target_w, target_h, out.ctypes.data_as(_U8_P),
        status.ctypes.data_as(_INT_P), n_threads, -1 if device is None else int(device),
    )
    ok[:n] = status == 0
    decodes["i420"] += int(ok.sum())
    return out, ok


def _decode_pixels(path, channels: int) -> Optional[np.ndarray]:
    lib = load_native()
    if lib is None:
        return None
    wh = probe_size(path)
    if wh is None:
        raise ValueError(f"{path}: not a readable JPEG")
    w, h = wh
    out = np.empty((h, w, channels), np.uint8)
    if lib.vc_decode_jpeg_pixels(str(path).encode(), w, h, channels,
                                 out.ctypes.data_as(_U8_P)):
        raise ValueError(f"{path}: JPEG decode failed")
    decodes["rgb" if channels == 3 else "gray"] += 1
    return out


def decode_jpeg_rgb(path) -> Optional[np.ndarray]:
    """(H, W, 3) uint8 RGB of a JPEG file as ``cv2.imread`` (colour) +
    BGR -> RGB decodes it, without its EXIF orientation; None when the
    library is unavailable, ``ValueError`` for a damaged file."""
    return _decode_pixels(path, 3)


def decode_jpeg_gray(path) -> Optional[np.ndarray]:
    """(H, W) uint8 of a JPEG file as ``cv2.IMREAD_GRAYSCALE`` decodes it
    (the Y plane), without its EXIF orientation; None when the library is
    unavailable."""
    out = _decode_pixels(path, 1)
    return None if out is None else out[..., 0]


def _u8(a: np.ndarray):
    return a.ctypes.data_as(_U8_P)


def decode_jpeg_ycc(path) -> Optional[np.ndarray]:
    """(H, W, 3) uint8 full-range YCbCr of a JPEG file, chroma upsampled
    to full resolution: the planes the I420 route resamples (libjpeg's
    decode, or nvJPEG's planes finished by libjpeg's upsampling); None
    when the library is unavailable."""
    lib = load_native()
    if lib is None:
        return None
    w, h = probe_size(path) or (0, 0)
    out = np.empty((h, w, 3), np.uint8)
    if w == 0 or lib.vc_decode_jpeg_ycc(str(path).encode(), w, h, _u8(out)):
        raise ValueError(f"{path}: JPEG decode failed")
    return out


def decode_jpeg_planes(path) -> Optional[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """The planes as the JPEG stores them, after the codec's IDCT: (H, W)
    luma and (ch, cw) Cb and Cr at their own sampling (empty for a gray
    file); None when the library is unavailable."""
    lib = load_native()
    if lib is None:
        return None
    w, h = probe_size(path) or (0, 0)
    cap = w * h
    y, cb, cr = (np.empty(cap, np.uint8) for _ in range(3))
    dims = np.zeros(4, np.int32)
    if cap == 0 or lib.vc_decode_jpeg_planes(str(path).encode(),
                                              dims.ctypes.data_as(_INT_P), _u8(y), _u8(cb),
                                              _u8(cr), cap):
        raise ValueError(f"{path}: JPEG decode failed")
    w, h, cw, ch = (int(v) for v in dims)
    return (y[: w * h].reshape(h, w), cb[: cw * ch].reshape(ch, cw),
            cr[: cw * ch].reshape(ch, cw))


def upsample_ycc(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """Stored planes (:func:`decode_jpeg_planes`) -> (H, W, 3) YCbCr by
    libjpeg's fancy upsampling, on the host (``csrc/host/jpeg_color.cc``)."""
    lib = load_native()
    if lib is None:
        raise RuntimeError("the native image library is unavailable")
    y, cb, cr = (np.ascontiguousarray(a, np.uint8) for a in (y, cb, cr))
    h, w = y.shape
    ch, cw = cb.shape
    out = np.empty((h, w, 3), np.uint8)
    if lib.vc_upsample_ycc(_u8(y), _u8(cb), _u8(cr), w, h, cw, ch, _u8(out)):
        raise ValueError(f"no upsampling takes chroma {cw}x{ch} to {w}x{h}")
    return out


def ycc_to_rgb(ycc: np.ndarray) -> np.ndarray:
    """(..., 3) YCbCr -> RGB by libjpeg's fixed-point conversion, on the
    host (``csrc/host/jpeg_color.cc``)."""
    lib = load_native()
    if lib is None:
        raise RuntimeError("the native image library is unavailable")
    planes = [np.ascontiguousarray(ycc[..., c], np.uint8) for c in range(3)]
    out = np.empty(ycc.shape, np.uint8)
    lib.vc_ycc_to_rgb(*(_u8(p) for p in planes), planes[0].size, _u8(out))
    return out


CHROMA = (420, 422, 440, 444)


def encode_jpeg(path, pixels: np.ndarray, quality: int = 95, chroma: int = 420) -> bool:
    """Write (H, W, 3) RGB or (H, W) gray uint8 as a baseline JPEG (colour
    with chroma sampling ``chroma``: 420, 422, 440 or 444); False when the
    library is unavailable."""
    lib = load_native()
    if lib is None:
        return False
    img = np.ascontiguousarray(pixels, np.uint8)
    channels = 1 if img.ndim == 2 else img.shape[2]
    if channels not in (1, 3) or not 1 <= quality <= 100 or chroma not in CHROMA:
        raise ValueError(f"encode_jpeg takes gray or RGB at quality 1-100 and chroma "
                         f"{CHROMA}, got {img.shape} at {quality}, {chroma}")
    if lib.vc_encode_jpeg(str(path).encode(), img.ctypes.data_as(_U8_P),
                          img.shape[1], img.shape[0], channels, int(quality), int(chroma)):
        raise OSError(f"{path}: JPEG encode failed")
    return True
