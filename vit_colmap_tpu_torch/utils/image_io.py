"""Image decoding and resizing without OpenCV or PIL.

Takes the place of ``cv2.imread(...)`` + ``cv2.cvtColor(BGR2RGB)`` and
``cv2.resize(..., interpolation=cv2.INTER_AREA)`` on the port's path:

* PNG (standard library ``zlib`` and numpy): 8-bit gray, gray+alpha, RGB
  and RGBA, non-interlaced, all five row filters.  Alpha is dropped and
  gray replicated, as ``cv2.IMREAD_COLOR`` does.
* Binary PPM (P6) and PGM (P5) with maxval <= 255.
* JPEG, through the host C++ decoder (``utils/native_io.py``, built with
  ``g++`` at first use): the pixels ``cv2.imread`` gives, turned by the
  file's EXIF orientation as ``cv2.imread`` turns them.  Without the
  native library (no ``g++`` or no JPEG runtime) JPEG raises
  ``NotImplementedError``.
* Anything else (interlaced or palette PNG, 16-bit) raises
  ``NotImplementedError``; a damaged file raises ``ValueError``.

``imread_gray`` takes the place of ``cv2.imread(..., cv2.IMREAD_GRAYSCALE)``
with OpenCV's conversions: a colour PNG goes through libpng's
``png_set_rgb_to_gray`` (BT.601 weights in 15-bit fixed point, truncated), a
PPM through the decoder's 14-bit fixed point, rounded, a JPEG is its Y
plane.  ``rgb_to_gray`` is
``cv2.cvtColor(COLOR_BGR2GRAY)`` on decoded pixels (``cv2.imread`` in
colour, then the conversion): 15-bit fixed point, rounded, which differs
from either ``IMREAD_GRAYSCALE`` conversion by up to 1.

``write_png``, ``write_ppm`` and ``write_jpeg`` write test images.

``resize_area`` is ``INTER_AREA``: when neither axis grows, each output
pixel is the area-weighted mean of the input pixels its footprint overlaps,
built as two separable weight matrices; when an axis grows, OpenCV's
bilinear resize with its area coefficients and 11-bit fixed-point
arithmetic (the same bytes as ``cv2.resize``).  ``resize_linear`` is
``cv2.resize``'s default ``INTER_LINEAR``: the same fixed-point bilinear
resize on its own coefficients (the same bytes).
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8"
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # color type -> samples per pixel


def imread_rgb(path) -> np.ndarray:
    """Decode an image file into (H, W, 3) uint8 RGB."""
    data = Path(path).read_bytes()
    if data.startswith(PNG_SIGNATURE):
        img = decode_png(data)
    elif data[:2] in (b"P5", b"P6"):
        img = decode_pnm(data)
    elif data.startswith(JPEG_SIGNATURE):
        return _read_jpeg(path, data, rgb=True)
    else:
        raise NotImplementedError(f"{path}: unsupported image format")
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[-1] in (1, 2):  # gray (+ alpha): replicate, drop alpha
        return np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def imread_gray(path) -> np.ndarray:
    """Decode an image file into (H, W) uint8 gray, as
    ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` does."""
    data = Path(path).read_bytes()
    if data.startswith(PNG_SIGNATURE):
        img = decode_png(data)
        if img.shape[-1] <= 2:  # gray (+ alpha): the gray samples
            return np.ascontiguousarray(img[..., 0])
        # libpng's rgb_to_gray with OpenCV's (0.299, 0.587): coefficients
        # 29900 * 32768 // 100000 and 58700 * 32768 // 100000, blue the rest
        # of 32768, the sum shifted down (truncated); grey pixels pass as is.
        rgb = img[..., :3].astype(np.uint32)
        r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
        gray = (9797 * r + 19234 * g + 3737 * b) >> 15
        return np.where((r == g) & (r == b), r, gray).astype(np.uint8)
    if data[:2] in (b"P5", b"P6"):
        img = decode_pnm(data)
        if img.shape[-1] == 1:
            return np.ascontiguousarray(img[..., 0])
        # The PxM decoder's RGB -> gray: 14-bit fixed point, rounded.
        rgb = img.astype(np.uint32)
        return ((4899 * rgb[..., 0] + 9617 * rgb[..., 1] + 1868 * rgb[..., 2] + 8192)
                >> 14).astype(np.uint8)
    if data.startswith(JPEG_SIGNATURE):
        return _read_jpeg(path, data, rgb=False)
    raise NotImplementedError(f"{path}: unsupported image format")


def _read_jpeg(path, data: bytes, rgb: bool) -> np.ndarray:
    """A JPEG's RGB or gray pixels from the native decoder, turned by its
    EXIF orientation."""
    from vit_colmap_tpu_torch.utils import native_io

    img = native_io.decode_jpeg_rgb(path) if rgb else native_io.decode_jpeg_gray(path)
    if img is None:
        raise NotImplementedError(
            f"{path}: JPEG needs the native image decoder, which is unavailable "
            "(g++, libz.so.1 and libjpeg.so.62 or nvJPEG; see the log)"
        )
    return apply_exif_orientation(img, exif_orientation(data))


def exif_orientation(data: bytes) -> int:
    """The orientation tag (0x0112) of a JPEG's Exif APP1 segment, 1..8, or
    1 where there is none (or it is out of range)."""
    pos = 2
    while pos + 4 <= len(data) and data[pos] == 0xFF:
        marker = data[pos + 1]
        if marker == 0xFF:  # fill byte
            pos += 1
            continue
        if marker in (0xD9, 0xDA):  # EOI, SOS: no more header segments
            break
        (length,) = struct.unpack(">H", data[pos + 2 : pos + 4])
        body = data[pos + 4 : pos + 2 + length]
        if marker == 0xE1 and body.startswith(b"Exif\0\0"):
            return _tiff_orientation(body[6:])
        pos += 2 + length
    return 1


def _tiff_orientation(tiff: bytes) -> int:
    if len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
        return 1
    end = "<" if tiff[:2] == b"II" else ">"
    (ifd,) = struct.unpack(end + "I", tiff[4:8])
    if ifd + 2 > len(tiff):
        return 1
    (count,) = struct.unpack(end + "H", tiff[ifd : ifd + 2])
    for k in range(count):
        entry = tiff[ifd + 2 + 12 * k : ifd + 14 + 12 * k]
        if len(entry) < 12:
            break
        tag, kind = struct.unpack(end + "HH", entry[:4])
        if tag == 0x0112 and kind == 3:  # SHORT, stored in the value field
            (value,) = struct.unpack(end + "H", entry[8:10])
            return value if 1 <= value <= 8 else 1
    return 1


def apply_exif_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """Turn decoded pixels upright, as OpenCV's ``imread`` does: 2 flips
    left-right, 3 turns 180 degrees, 4 flips top-bottom, 5-8 transpose and
    then flip nothing, left-right, both and top-bottom."""
    if orientation >= 5:
        img = img.swapaxes(0, 1)
    if orientation in (2, 3, 6, 7):
        img = img[:, ::-1]
    if orientation in (3, 4, 7, 8):
        img = img[::-1]
    return np.ascontiguousarray(img)


def rgb_to_gray(rgb: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 RGB -> (...) uint8 gray, as ``cv2.cvtColor(bgr,
    cv2.COLOR_BGR2GRAY)`` of the same pixels: BT.601 weights in 15-bit fixed
    point (9798, 19235, 3735), rounded.  ``imread_gray``'s PPM branch is
    the image decoder's own 14-bit conversion, which differs by up to 1."""
    c = np.asarray(rgb).astype(np.uint32)
    return ((9798 * c[..., 0] + 19235 * c[..., 1] + 3735 * c[..., 2] + 16384)
            >> 15).astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, C) uint8 with C samples per pixel."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG file")
    pos = len(PNG_SIGNATURE)
    header = None
    idat = []
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        if pos + 12 + length > len(data):
            raise ValueError("truncated PNG chunk")
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length : pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if header is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    w, h, depth, color, _compression, _filter, interlace = header
    if interlace != 0:
        raise NotImplementedError("interlaced PNG is not supported")
    if depth != 8 or color not in _PNG_CHANNELS:
        raise NotImplementedError(
            f"PNG bit depth {depth} / color type {color} is not supported "
            "(8-bit gray, gray+alpha, RGB, RGBA only)"
        )
    c = _PNG_CHANNELS[color]
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise ValueError(f"PNG image data: {e}") from e
    if raw.size != h * (w * c + 1):
        raise ValueError("PNG image data has the wrong size")
    rows = raw.reshape(h, w * c + 1)
    return _unfilter(rows[:, 0], rows[:, 1:].reshape(h, w, c))


def _unfilter(ftype: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Undo PNG row filters.  ftype: (H,) filter per row; x: (H, W, C)."""
    if ftype.size and ftype.max() > 4:
        raise ValueError("PNG row filter type > 4")
    h, w, c = x.shape
    if not np.isin(ftype, (3, 4)).any():
        # None / Sub / Up only: one vectorized step per row.
        out = np.empty((h, w, c), np.uint8)
        prev = np.zeros((w, c), np.uint8)
        for r in range(h):
            row = x[r]
            if ftype[r] == 1:
                row = np.cumsum(row, axis=0, dtype=np.uint32).astype(np.uint8)
            elif ftype[r] == 2:
                row = row + prev  # uint8 arithmetic wraps mod 256
            out[r] = row
            prev = out[r]
        return out
    # Average / Paeth make each pixel depend on its left, upper and
    # upper-left neighbours: decode along anti-diagonals, all rows at once,
    # each row with its own filter.  A zero border stands for the pixels
    # outside the image.
    out = np.zeros((h + 1, w + 1, c), np.int32)
    xi = x.astype(np.int32)
    ft = ftype.astype(np.int32)
    for k in range(h + w - 1):
        r = np.arange(max(0, k - w + 1), min(h - 1, k) + 1)
        cc = k - r
        a = out[r + 1, cc]  # left
        b = out[r, cc + 1]  # up
        ul = out[r, cc]  # upper left
        p = a + b - ul
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, ul))
        f = ft[r][:, None]
        pred = np.select(
            [f == 1, f == 2, f == 3, f == 4],
            [a, b, (a + b) >> 1, paeth],
            default=0,
        )
        out[r + 1, cc + 1] = (xi[r, cc] + pred) & 255
    return out[1:, 1:].astype(np.uint8)


def decode_pnm(data: bytes) -> np.ndarray:
    """Binary PGM (P5) / PPM (P6) bytes -> (H, W, C) uint8."""
    fields = []
    pos = 0
    while len(fields) < 4:
        while pos < len(data) and data[pos : pos + 1].isspace():
            pos += 1
        if data[pos : pos + 1] == b"#":
            while pos < len(data) and data[pos : pos + 1] not in (b"\n", b"\r"):
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos : pos + 1].isspace():
            pos += 1
        if start == pos:
            raise ValueError("truncated PNM header")
        fields.append(data[start:pos])
    pos += 1  # exactly one whitespace byte ends the header
    magic = fields[0]
    w, h, maxval = (int(f) for f in fields[1:])
    if maxval > 255:
        raise NotImplementedError("16-bit PNM is not supported")
    c = 3 if magic == b"P6" else 1
    pixels = np.frombuffer(data, np.uint8, count=h * w * c, offset=pos)
    return pixels.reshape(h, w, c)


def write_png(path, rgb: np.ndarray) -> None:
    """Write (H, W, 3) or (H, W) uint8 as an 8-bit PNG with no row filter."""
    img = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w = img.shape[:2]
    color = 2 if img.ndim == 3 else 0
    rows = img.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()

    def chunk(kind: bytes, body: bytes) -> bytes:
        crc = zlib.crc32(kind + body)
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", crc)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    Path(path).write_bytes(
        PNG_SIGNATURE
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )


def write_jpeg(path, img: np.ndarray, quality: int = 95) -> None:
    """Write (H, W, 3) RGB or (H, W) gray uint8 as a baseline JPEG at
    ``quality`` (4:2:0 chroma), through the native encoder."""
    from vit_colmap_tpu_torch.utils import native_io

    if not native_io.encode_jpeg(path, img, quality):
        raise NotImplementedError(
            f"{path}: writing JPEG needs the native image library, which is "
            "unavailable (see the log)"
        )


def write_ppm(path, rgb: np.ndarray) -> None:
    """Write (H, W, 3) uint8 RGB as a binary PPM (P6, maxval 255)."""
    img = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w = img.shape[:2]
    Path(path).write_bytes(b"P6\n%d %d\n255\n" % (w, h) + img.tobytes())


def area_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) INTER_AREA weights: output pixel i covers the input
    interval [i*s, (i+1)*s) with s = n_in / n_out, each input pixel weighted
    by the length of its overlap, normalized by s."""
    if n_out > n_in:
        raise ValueError(f"area resize only downscales ({n_in} -> {n_out})")
    s = n_in / n_out
    lo = np.arange(n_out)[:, None] * s
    hi = lo + s
    j = np.arange(n_in)[None, :]
    overlap = np.clip(np.minimum(hi, j + 1) - np.maximum(lo, j), 0.0, None)
    return overlap / s


def _area_linear_coeffs(n_in: int, n_out: int):
    """OpenCV's ``INTER_AREA`` coefficients on its bilinear path (an axis
    grows): per output index the source index and the two weights in
    11-bit fixed point."""
    inv_scale = n_out / n_in
    dx = np.arange(n_out)
    sx = np.floor(dx * (1.0 / inv_scale)).astype(np.int64)
    fx = ((dx + 1) - (sx + 1) * inv_scale).astype(np.float32)
    fx = np.where(fx <= 0, np.float32(0), fx - np.floor(fx)).astype(np.float32)
    fx = np.where(sx < 0, np.float32(0), fx)
    sx = np.maximum(sx, 0)
    last = sx >= n_in - 1
    fx = np.where(last, np.float32(0), fx)
    sx = np.where(last, n_in - 1, sx)
    scale = np.float32(1 << 11)
    return sx, np.rint((np.float32(1) - fx) * scale).astype(np.int64), np.rint(
        fx * scale).astype(np.int64)


def _resize_fixed_point(img: np.ndarray, cols, rows) -> np.ndarray:
    """(H, W, C) uint8 -> (len(rows[0]), len(cols[0]), C): OpenCV's uint8
    bilinear resize on 11-bit coefficients (per output index the first
    source index and two weights; the second source index is clamped to
    the image): rows of the horizontal pass in fixed point, then columns
    as its vector code rounds them (products' high halves of the rows
    shifted by 4, plus 2, shifted by 2)."""
    h, w = img.shape[:2]
    (sx, ax0, ax1), (sy, by0, by1) = cols, rows
    src = img.astype(np.int64)
    hor = (src[:, sx] * ax0[None, :, None]
           + src[:, np.minimum(sx + 1, w - 1)] * ax1[None, :, None])
    s0 = hor[np.clip(sy, 0, h - 1)] >> 4
    s1 = hor[np.clip(sy + 1, 0, h - 1)] >> 4
    out = ((s0 * by0[:, None, None]) >> 16) + ((s1 * by1[:, None, None]) >> 16)
    return np.clip((out + 2) >> 2, 0, 255).astype(np.uint8)


def resize_area(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """(H, W, C) uint8 -> (height, width, C) uint8, as ``cv2.resize(img,
    (width, height), interpolation=cv2.INTER_AREA)``."""
    h, w = img.shape[:2]
    if (h, w) == (height, width):
        return img
    if width > w or height > h:
        return _resize_fixed_point(img, _area_linear_coeffs(w, width),
                                   _area_linear_coeffs(h, height))
    wy = area_weights(h, height)
    wx = area_weights(w, width)
    c = img.shape[2]
    rows = (wy @ img.reshape(h, w * c).astype(np.float64)).reshape(height, w, c)
    out = np.tensordot(rows, wx, axes=([1], [1])).transpose(0, 2, 1)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def _linear_coeffs(n_in: int, n_out: int, clamp: bool):
    """OpenCV's ``INTER_LINEAR`` coefficients: per output index the first
    source index and the two weights in 11-bit fixed point.  Columns are
    clamped to the image (source index and weight 0 at either edge); rows
    are not: an edge row keeps its weights and reads the edge row twice."""
    fx = ((np.arange(n_out) + 0.5) * (1.0 / (n_out / n_in)) - 0.5).astype(np.float32)
    sx = np.floor(fx).astype(np.int64)
    fx = (fx - sx).astype(np.float32)
    if clamp:
        out = (sx < 0) | (sx >= n_in - 1)
        fx = np.where(out, np.float32(0), fx)
        sx = np.clip(sx, 0, n_in - 1)
    scale = np.float32(1 << 11)
    return (sx, np.rint((np.float32(1) - fx) * scale).astype(np.int64),
            np.rint(fx * scale).astype(np.int64))


def resize_linear(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """(H, W[, C]) uint8 -> (height, width[, C]) uint8 (no channel axis for
    C = 1), as ``cv2.resize(img, (width, height))`` (``INTER_LINEAR``; not
    ``INTER_LINEAR_EXACT``, whose weights and rounding differ)."""
    h, w = img.shape[:2]
    out = _resize_fixed_point(np.asarray(img).reshape(h, w, -1),
                              _linear_coeffs(w, width, clamp=True),
                              _linear_coeffs(h, height, clamp=False))
    # cv2 returns a one-channel image without its channel axis.
    return out.reshape((height, width) + tuple(c for c in img.shape[2:] if c > 1))
