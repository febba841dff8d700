"""The YUV420 wire formats: host packers in numpy, device unpackers in
PyTorch.

Counterpart of ``vit_colmap_tpu/ops/transfer.py``.  I420 sends 1.5 bytes a
pixel instead of RGB's 3 (chroma subsampled 2x2); ``yuv420c4`` quantizes
the chroma to 4 bits and packs two samples a byte, 1.125 bytes a pixel.
The card rebuilds RGB before the backbone: bilinear chroma upsampling and
the BT.601 inverse, studio range (cv2's I420) or full range (JFIF).

The packers are the port's own: :func:`pack_yuv420` is cv2's
``COLOR_RGB2YUV_I420`` in numpy (its 20-bit fixed-point BT.601 weights,
rounded, with each 2x2 block's chroma from its top-left pixel), which the
card's machine lacks.

Wire layout of ``yuv420c4``, rows of width W: rows 0..H-1 luma as is, then
ceil(H/4) rows holding concat(U4.flat, V4.flat) two samples a byte (high
nibble first), zero-padded to whole rows; H is recovered from the row
count (unique over even H, which I420 needs anyway).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# cv2's RGB -> YUV (I420) fixed point: 20 fractional bits (its ITUR_BT_601
# constants of the 4:2:0 converters, studio range).
_SHIFT = 20
_HALF = 1 << (_SHIFT - 1)
_RY, _GY, _BY = 269484, 528482, 102760
_RU, _GU, _BU = -155188, -305135, 460324
_RV, _GV, _BV = 460324, -385875, -74448


def _fixed(rgb_u8: np.ndarray, coef, offset: int) -> np.ndarray:
    """One plane of cv2's fixed-point RGB -> YUV: the weighted sum, rounded
    and shifted down, plus ``offset``, saturated to uint8 (int32 throughout:
    every sum stays below 2^31)."""
    acc = rgb_u8[..., 0].astype(np.int32) * coef[0]
    acc += rgb_u8[..., 1].astype(np.int32) * coef[1]
    acc += rgb_u8[..., 2].astype(np.int32) * coef[2]
    acc += _HALF + (offset << _SHIFT)
    acc >>= _SHIFT
    return np.clip(acc, 0, 255).astype(np.uint8)


def pack_yuv420(rgb_u8: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 RGB -> (H*3/2, W) uint8 I420, as
    ``cv2.cvtColor(rgb, cv2.COLOR_RGB2YUV_I420)``."""
    h, w = rgb_u8.shape[:2]
    assert h % 2 == 0 and w % 2 == 0, "I420 needs even dims (patch-aligned ok)"
    y = _fixed(rgb_u8, (_RY, _GY, _BY), 16)
    # Chroma from the top-left pixel of each 2x2 block, as cv2 takes it.
    tl = rgb_u8[::2, ::2]
    out = np.concatenate([y.ravel(), _fixed(tl, (_RU, _GU, _BU), 128).ravel(),
                          _fixed(tl, (_RV, _GV, _BV), 128).ravel()])
    return out.reshape(h * 3 // 2, w)


def pack_batch_yuv420(rgb_batch_u8: np.ndarray) -> np.ndarray:
    """(B, H, W, 3) -> (B, H*3/2, W) uint8."""
    return np.stack([pack_yuv420(im) for im in rgb_batch_u8])


def pack_yuv420_full(rgb_u8: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 RGB -> (H*3/2, W) uint8 I420 in JFIF full range (the
    native decoder's convention), chroma the 2x2 mean."""
    h, w = rgb_u8.shape[:2]
    assert h % 2 == 0 and w % 2 == 0
    rgb = rgb_u8.astype(np.float32)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0

    def sub(c):
        return c.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3))

    out = np.empty((h * 3 // 2, w), np.uint8)
    flat = out.reshape(-1)
    n_y, n_c = h * w, (h // 2) * (w // 2)
    flat[:n_y] = np.clip(y + 0.5, 0, 255).astype(np.uint8).reshape(-1)
    flat[n_y:n_y + n_c] = np.clip(sub(cb) + 0.5, 0, 255).astype(np.uint8).reshape(-1)
    flat[n_y + n_c:] = np.clip(sub(cr) + 0.5, 0, 255).astype(np.uint8).reshape(-1)
    return out


def _c4_rows(h: int) -> int:
    """Chroma rows of the 4-bit layout: ceil((H*W/4 bytes) / W)."""
    return (h + 3) // 4


def _solve_h_c4(rows: int) -> int:
    """The even H with rows = H + ceil(H/4)."""
    h0 = (rows * 4) // 5
    h0 -= h0 % 2
    for h in (h0 - 2, h0, h0 + 2):
        if h > 0 and h + _c4_rows(h) == rows:
            return h
    raise ValueError(f"no even H with H + ceil(H/4) == {rows}")


def i420_to_c4(i420: np.ndarray) -> np.ndarray:
    """(H*3/2, W) or (B, H*3/2, W) uint8 I420 -> the 4-bit-chroma wire
    (..., H + ceil(H/4), W)."""
    batched = i420.ndim == 3
    arr = i420 if batched else i420[None]
    B, h15, w = arr.shape
    h = (h15 * 2) // 3
    n_y = h * w
    flat = arr.reshape(B, -1)
    # q = rint(c / 17), exact at both ends (0 -> 0, 255 -> 15), in integers:
    # (c * 6 + 51) // 102 (c / 17 never lands on .5).  Dequantized as q * 17.
    q = ((flat[:, n_y:].astype(np.uint16) * 6 + 51) // 102).astype(np.uint8)
    pb = (q[:, 0::2] << 4) | q[:, 1::2]  # (B, h*w/4)
    out = np.zeros((B, (h + _c4_rows(h)) * w), np.uint8)
    out[:, :n_y] = flat[:, :n_y]
    out[:, n_y:n_y + pb.shape[1]] = pb
    out = out.reshape(B, h + _c4_rows(h), w)
    return out if batched else out[0]


def pack_batch_yuv420_c4(rgb_batch_u8: np.ndarray, full_range: bool = False) -> np.ndarray:
    """(B, H, W, 3) uint8 RGB -> (B, H + ceil(H/4), W) 4-bit-chroma wire."""
    if full_range:
        i420 = np.stack([pack_yuv420_full(im) for im in rgb_batch_u8])
    else:
        i420 = pack_batch_yuv420(rgb_batch_u8)
    return i420_to_c4(i420)


def _planes_to_rgb(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                   full_range: bool) -> torch.Tensor:
    """(B, H, W) f32 luma + (B, H/2, W/2) f32 chroma -> (B, H, W, 3) RGB in
    [0, 255]: bilinear chroma upsampling on half-pixel centres (the
    reference's ``jax.image.resize(..., "bilinear")`` at 2x) and the BT.601
    inverse."""
    h, w = y.shape[1:]
    uv = F.interpolate(torch.stack([u, v], dim=1), size=(h, w), mode="bilinear",
                       align_corners=False) - 128.0
    u, v = uv[:, 0], uv[:, 1]
    if full_range:  # JFIF full-range inverse
        r = y + 1.402 * v
        g = y - 0.344136 * u - 0.714136 * v
        b = y + 1.772 * u
    else:  # studio-range inverse (cv2's I420)
        yc = 1.164383 * (y - 16.0)
        r = yc + 1.596027 * v
        g = yc - 0.391762 * u - 0.812968 * v
        b = yc + 2.017232 * u
    return torch.clamp(torch.stack([r, g, b], dim=-1), 0.0, 255.0)


def unpack_yuv420(packed: torch.Tensor, full_range: bool = False) -> torch.Tensor:
    """(B, H*3/2, W) uint8 I420 -> (B, H, W, 3) f32 RGB in [0, 255].

    ``full_range=False`` is cv2's I420 (studio range, what
    :func:`pack_yuv420` emits); ``True`` is JFIF full range."""
    B, h15, w = packed.shape
    h = (h15 * 2) // 3
    # The planes are contiguous but not row-aligned when h % 4 != 0.
    flat = packed.reshape(B, -1)
    n_y, n_c = h * w, (h // 2) * (w // 2)
    y = flat[:, :n_y].reshape(B, h, w).to(torch.float32)
    u = flat[:, n_y:n_y + n_c].reshape(B, h // 2, w // 2).to(torch.float32)
    v = flat[:, n_y + n_c:].reshape(B, h // 2, w // 2).to(torch.float32)
    return _planes_to_rgb(y, u, v, full_range)


def unpack_yuv420_c4(packed: torch.Tensor, full_range: bool = False) -> torch.Tensor:
    """(B, H + ceil(H/4), W) 4-bit-chroma wire -> (B, H, W, 3) f32 RGB:
    nibble unpacking, x17 dequantization and :func:`_planes_to_rgb`."""
    B, rows, w = packed.shape
    h = _solve_h_c4(rows)
    n_y = h * w
    flat = packed.reshape(B, -1)
    y = flat[:, :n_y].reshape(B, h, w).to(torch.float32)
    cb = flat[:, n_y:n_y + n_y // 4]
    hi = (cb >> 4).to(torch.float32) * 17.0
    lo = (cb & 0xF).to(torch.float32) * 17.0
    cat = torch.stack([hi, lo], dim=-1).reshape(B, -1)  # (B, h*w/2)
    n_c = (h // 2) * (w // 2)
    u = cat[:, :n_c].reshape(B, h // 2, w // 2)
    v = cat[:, n_c:].reshape(B, h // 2, w // 2)
    return _planes_to_rgb(y, u, v, full_range)
