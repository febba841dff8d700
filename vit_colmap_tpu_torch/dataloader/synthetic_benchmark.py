"""Rendered benchmarks in numpy, without OpenCV.

Counterpart of ``vit_colmap_tpu/dataloader/synthetic_benchmark.py``'s
:func:`make_structured_image`, :func:`generate_synthetic_hpatches` (an
HPatches-layout tree: ``i_*`` / ``v_*`` sequences of ``k.ppm`` images and
``H_1_k`` homographies) and :func:`render_multiview_scene`: the same
random draws in the same order (so the same shapes, colours, planes and
cameras), with numpy versions of the OpenCV calls the reference renders
with:

* ``cv2.resize(..., INTER_CUBIC)`` upsampling: :func:`resize_cubic`
  (a = -0.75, half-pixel centres, edge samples repeated);
* ``cv2.circle``, ``cv2.fillPoly`` and ``cv2.line``: :func:`fill_circle`
  (OpenCV's midpoint disc; rings as a band of pixel centres),
  :func:`fill_triangle` and :func:`draw_line` (Bresenham, or OpenCV's
  quadrilateral with round ends);
* ``cv2.GaussianBlur(img, (0, 0), 1.0)``: :func:`gaussian_blur_u8` (7 taps,
  borders reflected without repeating the edge, rounded);
* ``cv2.getPerspectiveTransform``: :func:`perspective_transform`;
* ``cv2.warpPerspective`` (bilinear, constant-0 border): :func:`warp_perspective`,
  on source coordinates quantized to 1/32 pixel as OpenCV's are.

The rings, thick lines and edge pixels are not OpenCV's pixel for pixel, so
the pixels differ slightly from the reference's
and the scenes are compared, not held bit for bit
(``tests/test_torch_render.py``).  Images are written with
``utils.image_io.write_png`` / ``write_ppm``, in OpenCV's BGR channel
order, and the poses with ``sfm.align.save_gt_poses``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from vit_colmap_tpu_torch.sfm.align import save_gt_poses
from vit_colmap_tpu_torch.utils.image_io import write_png, write_ppm


def _cubic_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) INTER_CUBIC weights: source x = (i + 0.5) * s - 0.5,
    four taps with A = -0.75, indices outside the image clamped to it."""
    scale = n_in / n_out
    fx = ((np.arange(n_out) + 0.5) * scale - 0.5).astype(np.float32)
    sx = np.floor(fx).astype(np.int64)
    x = (fx - sx).astype(np.float32)
    A = np.float32(-0.75)
    c0 = ((A * (x + 1) - 5 * A) * (x + 1) + 8 * A) * (x + 1) - 4 * A
    c1 = ((A + 2) * x - (A + 3)) * x * x + 1
    c2 = ((A + 2) * (1 - x) - (A + 3)) * (1 - x) * (1 - x) + 1
    c3 = 1 - c0 - c1 - c2
    w = np.zeros((n_out, n_in), np.float64)
    rows = np.arange(n_out)
    for k, c in enumerate((c0, c1, c2, c3)):
        np.add.at(w, (rows, np.clip(sx - 1 + k, 0, n_in - 1)), c)
    return w


def resize_cubic(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """(H, W, C) float32 -> (height, width, C) float32, as ``cv2.resize(img,
    (width, height), interpolation=cv2.INTER_CUBIC)``."""
    h, w, c = img.shape
    wy = _cubic_weights(h, height)
    wx = _cubic_weights(w, width)
    rows = (wy @ img.astype(np.float64).reshape(h, w * c)).reshape(height, w, c)
    return np.matmul(wx, rows).astype(np.float32)  # (width, w) @ (height, w, c)


def _pixel_grid(h: int, w: int):
    yy, xx = np.mgrid[0:h, 0:w]
    return xx.astype(np.float64), yy.astype(np.float64)


def _disc(img: np.ndarray, center, radius: int, color) -> None:
    """OpenCV's filled circle: midpoint-algorithm spans, drawn in place."""
    h, w = img.shape[:2]
    cx, cy = center

    def span(y, x1, x2):
        x1, x2 = max(x1, 0), min(x2, w - 1)
        if 0 <= y < h and x1 <= x2:
            img[y, x1:x2 + 1] = color

    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        span(cy - dy, cx - dx, cx + dx)
        span(cy + dy, cx - dx, cx + dx)
        span(cy - dx, cx - dy, cx + dy)
        span(cy + dx, cx - dy, cx + dy)
        dy += 1
        err += plus
        plus += 2
        mask = -1 if err > 0 else 0
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def fill_circle(img: np.ndarray, center, radius: int, color, thickness: int) -> None:
    """``cv2.circle``: its filled disc (thickness < 0) exactly, or a ring
    of pixel centres within 0.75 x thickness of the radius, drawn in
    place."""
    if thickness < 0:
        _disc(img, center, radius, color)
        return
    r = radius + 0.75 * thickness + 1
    y0, x0, sub = _box(img, center[0] - r, center[0] + r, center[1] - r, center[1] + r)
    xx, yy = _pixel_grid(*sub.shape[:2])
    d = np.hypot(xx + x0 - center[0], yy + y0 - center[1])
    sub[np.abs(d - radius) <= 0.75 * thickness] = color


def _box(img: np.ndarray, x_lo: float, x_hi: float, y_lo: float, y_hi: float):
    """(y0, x0, view) of the pixels of ``img`` in [x_lo, x_hi] x [y_lo,
    y_hi], clipped to the image: only they can be drawn."""
    h, w = img.shape[:2]
    x0, x1 = int(max(np.floor(x_lo), 0)), int(min(np.ceil(x_hi) + 1, w))
    y0, y1 = int(max(np.floor(y_lo), 0)), int(min(np.ceil(y_hi) + 1, h))
    return y0, x0, img[y0:max(y1, y0), x0:max(x1, x0)]


def _convex_margin(p: np.ndarray) -> float:
    """How far beyond the vertices of a convex polygon (k, 2) its
    half-planes widened by half a pixel reach: the miter 0.5 / sin(a / 2)
    at its sharpest angle a, plus one pixel; infinite for a polygon so thin
    (twice its area at most half its perimeter) that the widened
    half-planes may hold a strip along it."""
    k = len(p)
    edges = np.roll(p, -1, axis=0) - p
    lengths = np.hypot(edges[:, 0], edges[:, 1])
    area2 = abs(float(np.sum(p[:, 0] * np.roll(p[:, 1], -1) - np.roll(p[:, 0], -1) * p[:, 1])))
    if area2 <= 0.5 * lengths.sum() or lengths.min() == 0:
        return np.inf
    cos = [-(edges[i - 1] @ edges[i]) / (lengths[i - 1] * lengths[i]) for i in range(k)]
    half = np.arccos(np.clip(cos, -1.0, 1.0)) / 2.0
    return 0.5 / max(float(np.sin(half).min()), 1e-12) + 1.0


def _fill_convex(img: np.ndarray, pts: np.ndarray, color) -> None:
    """Pixel centres inside a convex polygon (k, 2), or within half a pixel
    of an edge (the rasterizer also fills the edges' pixels), in place."""
    p = pts.astype(np.float64)
    m = _convex_margin(p)
    y0, x0, sub = _box(img, p[:, 0].min() - m, p[:, 0].max() + m, p[:, 1].min() - m,
                       p[:, 1].max() + m)
    xx, yy = _pixel_grid(*sub.shape[:2])
    xx, yy = xx + x0, yy + y0
    side = []
    for i in range(len(p)):
        a, b = p[i], p[(i + 1) % len(p)]
        edge = max(float(np.hypot(*(b - a))), 1e-9)
        side.append(((b[0] - a[0]) * (yy - a[1]) - (b[1] - a[1]) * (xx - a[0])) / edge)
    s = np.stack(side)
    sub[(s >= -0.5).all(0) | (s <= 0.5).all(0)] = color


def fill_triangle(img: np.ndarray, pts: np.ndarray, color) -> None:
    """``cv2.fillPoly`` of one triangle (3, 2) int, drawn in place."""
    _fill_convex(img, pts, color)


def draw_line(img: np.ndarray, p1, p2, color, thickness: int) -> None:
    """``cv2.line``: Bresenham for thickness 1; otherwise OpenCV's thick
    line, a quadrilateral ``thickness`` wide with a disc of radius
    ``(thickness + 1) // 2`` at each end; drawn in place."""
    if thickness <= 1:
        h, w = img.shape[:2]
        (x, y), (x1, y1) = p1, p2
        dx, dy = abs(x1 - x), abs(y1 - y)
        sx, sy = (1 if x1 >= x else -1), (1 if y1 >= y else -1)
        steep = dy > dx
        if steep:
            dx, dy = dy, dx
        err = dx - 2 * dy
        for _ in range(dx + 1):
            if 0 <= y < h and 0 <= x < w:
                img[y, x] = color
            if err < 0:
                err += 2 * dx
                if steep:
                    x += sx
                else:
                    y += sy
            err -= 2 * dy
            if steep:
                y += sy
            else:
                x += sx
        return
    a, b = np.asarray(p1, np.float64), np.asarray(p2, np.float64)
    d = b - a
    length = float(np.hypot(*d))
    if length > 0:
        n = np.array([-d[1], d[0]]) / length * (thickness / 2.0)
        _fill_convex(img, np.array([a + n, a - n, b - n, b + n]), color)
    for end in (p1, p2):
        _disc(img, end, (thickness + 1) // 2, color)


def gaussian_blur_u8(img: np.ndarray, sigma: float = 1.0) -> np.ndarray:
    """``cv2.GaussianBlur(img, (0, 0), sigma)`` of a uint8 image: a
    ``round(6 sigma + 1) | 1``-tap kernel, borders reflected without
    repeating the edge pixel (BORDER_REFLECT_101), rounded."""
    ksize = int(round(sigma * 3 * 2 + 1)) | 1
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2 * sigma * sigma))
    k /= k.sum()
    out = img.astype(np.float64)
    for axis in (0, 1):
        pad = [(0, 0)] * out.ndim
        pad[axis] = (r, r)
        p = np.pad(out, pad, mode="reflect")
        n = out.shape[axis]
        out = sum(k[i] * np.take(p, np.arange(i, i + n), axis=axis) for i in range(ksize))
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def perspective_transform(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """``cv2.getPerspectiveTransform``: the 3x3 homography (H[2, 2] = 1)
    taking four src points to four dst points."""
    A = np.zeros((8, 8))
    b = np.zeros(8)
    for i, ((x, y), (u, v)) in enumerate(zip(src.astype(np.float64), dst.astype(np.float64))):
        A[i] = [x, y, 1, 0, 0, 0, -x * u, -y * u]
        A[i + 4] = [0, 0, 0, x, y, 1, -x * v, -y * v]
        b[i], b[i + 4] = u, v
    return np.append(np.linalg.solve(A, b), 1.0).reshape(3, 3)


def warp_perspective(src: np.ndarray, H: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """``cv2.warpPerspective(src, H, (w, h))``: each destination pixel reads
    ``src`` at ``H^-1 (x, y)``, quantized to 1/32 pixel, bilinearly, with
    pixels outside the source read as 0; rounded to uint8.  Only the box
    around the source's image is computed (the rest is 0)."""
    w, h = size
    sh, sw = src.shape[:2]
    img = src if src.ndim == 3 else src[..., None]
    out = np.zeros((h, w, img.shape[2]), np.uint8)
    corners = H @ np.array([[-1, sw, sw, -1], [-1, -1, sh, sh], [1, 1, 1, 1]], np.float64)
    if (corners[2] > 0).all():
        x = corners[0] / corners[2]
        y = corners[1] / corners[2]
        x0b, x1b = max(int(np.floor(x.min())) - 1, 0), min(int(np.ceil(x.max())) + 2, w)
        y0b, y1b = max(int(np.floor(y.min())) - 1, 0), min(int(np.ceil(y.max())) + 2, h)
    else:  # the source plane crosses the camera: compute every pixel
        x0b, x1b, y0b, y1b = 0, w, 0, h
    if x0b >= x1b or y0b >= y1b:
        return out if src.ndim == 3 else out[..., 0]
    M = np.linalg.inv(H)
    yy, xx = np.mgrid[y0b:y1b, x0b:x1b].astype(np.float64)
    W = M[2, 0] * xx + M[2, 1] * yy + M[2, 2]
    W = np.where(W != 0, 32.0 / np.where(W != 0, W, 1.0), 0.0)
    X = np.rint((M[0, 0] * xx + M[0, 1] * yy + M[0, 2]) * W).astype(np.int64)
    Y = np.rint((M[1, 0] * xx + M[1, 1] * yy + M[1, 2]) * W).astype(np.int64)
    x0, y0 = X >> 5, Y >> 5
    # Weights are multiples of 1/1024 and pixels 8-bit: every product and
    # the sum of four are exact in float32.
    fx, fy = (X & 31).astype(np.float32) / 32, (Y & 31).astype(np.float32) / 32
    flat = img.reshape(sh * sw, -1).astype(np.float32)
    acc = np.zeros((*X.shape, img.shape[2]), np.float32)
    for dy, wy in ((0, 1 - fy), (1, fy)):
        for dx, wx in ((0, 1 - fx), (1, fx)):
            xs, ys = x0 + dx, y0 + dy
            inside = (xs >= 0) & (xs < sw) & (ys >= 0) & (ys < sh)
            idx = np.clip(ys, 0, sh - 1) * sw + np.clip(xs, 0, sw - 1)
            acc += np.where(inside, wx * wy, np.float32(0))[..., None] * flat[idx]
    out[y0b:y1b, x0b:x1b] = np.clip(np.rint(acc), 0, 255).astype(np.uint8)
    return out if src.ndim == 3 else out[..., 0]


def make_structured_image(rng: np.random.Generator, h: int = 480, w: int = 640) -> np.ndarray:
    """A base image with structure at several scales: multi-octave smooth
    noise plus filled shapes and lines, lightly blurred; the reference's
    draws, in its order."""
    img = np.zeros((h, w, 3), np.float32)
    for scale, amp in ((4, 0.20), (16, 0.35), (64, 0.45)):
        small = rng.random((max(2, h // scale), max(2, w // scale), 3)).astype(np.float32)
        img += amp * resize_cubic(small, w, h)
    img -= img.min()
    img /= img.max() + 1e-9
    img = (img * 255).astype(np.uint8)
    for _ in range(40):
        color = tuple(int(c) for c in rng.integers(0, 256, 3))
        kind = int(rng.integers(0, 3))
        if kind == 0:
            center = (int(rng.integers(0, w)), int(rng.integers(0, h)))
            radius = int(rng.integers(5, 60))
            thickness = -1 if rng.random() < 0.7 else 2
            fill_circle(img, center, radius, color, thickness)
        elif kind == 1:
            pts = np.stack([rng.integers(0, w, 3), rng.integers(0, h, 3)],
                           axis=1).astype(np.int32)
            fill_triangle(img, pts, color)
        else:
            p1 = (int(rng.integers(0, w)), int(rng.integers(0, h)))
            p2 = (int(rng.integers(0, w)), int(rng.integers(0, h)))
            draw_line(img, p1, p2, color, int(rng.integers(1, 5)))
    return gaussian_blur_u8(img, 1.0)


def _photometric_variant(rng: np.random.Generator, img: np.ndarray) -> np.ndarray:
    """Illumination change: gamma + gain/bias + mild noise (H = identity)."""
    gamma = float(rng.uniform(0.55, 1.7))
    gain = float(rng.uniform(0.7, 1.25))
    bias = float(rng.uniform(-25, 25))
    x = (img.astype(np.float32) / 255.0) ** gamma
    x = x * 255.0 * gain + bias
    x += rng.normal(0, 2.0, img.shape)
    return np.clip(x, 0, 255).astype(np.uint8)


def generate_synthetic_hpatches(
    root: Path,
    n_illum: int = 4,
    n_view: int = 6,
    n_img: int = 6,
    size: tuple[int, int] = (480, 640),
    seed: int = 0,
    preset: str = "moderate",
) -> list[str]:
    """Write an HPatches-layout tree under ``root``: ``n_illum`` illumination
    sequences (photometric variants, H = identity) and ``n_view`` viewpoint
    sequences (the base image warped by random homographies), each of
    ``n_img`` PPM images of ``size`` (h, w) and their ``H_1_k`` files; the
    reference's draws in its order.  Returns the sequence names."""
    from vit_colmap_tpu_torch.dataloader.synthetic_homography import (
        SyntheticHomographyConfig,
        generate_random_homography,
    )

    root = Path(root)
    h, w = size
    cfg = getattr(SyntheticHomographyConfig, preset)()
    rng = np.random.default_rng(seed)
    names = [f"i_synth{k}" for k in range(n_illum)] + [f"v_synth{k}" for k in range(n_view)]
    for name in names:
        d = root / name
        d.mkdir(parents=True, exist_ok=True)
        base = make_structured_image(rng, h, w)
        write_ppm(d / "1.ppm", base[..., ::-1])  # OpenCV writes BGR arrays
        for j in range(2, n_img + 1):
            if name.startswith("i_"):
                H = np.eye(3)
                img_j = _photometric_variant(rng, base)
            else:
                H = generate_random_homography(w, h, cfg, rng)
                img_j = warp_perspective(base, H, (w, h))
            write_ppm(d / f"{j}.ppm", img_j[..., ::-1])
            np.savetxt(str(d / f"H_1_{j}"), H)
    return names


# The scene: far backdrop plus two slanted near planes (corners, texture size).
PLANES = (
    ([[-3.2, -2.4, 6.5], [3.2, -2.4, 6.5], [3.2, 2.4, 6.5], [-3.2, 2.4, 6.5]], 512),
    ([[-2.2, -1.5, 5.4], [0.2, -1.4, 4.6], [0.2, 1.4, 4.6], [-2.2, 1.5, 5.4]], 384),
    ([[0.3, -1.3, 4.4], [2.3, -1.5, 5.2], [2.3, 1.5, 5.2], [0.3, 1.3, 4.4]], 384),
)


def arc_cameras(n_cams: int, arc: float = 0.35) -> list[tuple[np.ndarray, np.ndarray]]:
    """World -> camera (R, t) of ``n_cams`` cameras on an arc of ``arc``
    radians, whatever their number."""
    cams = []
    for i in range(n_cams):
        ang = (i - (n_cams - 1) / 2) * (arc / max(n_cams - 1, 1))
        R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                      [-np.sin(ang), 0, np.cos(ang)]])
        C = np.array([2.0 * np.sin(ang), 0.04 * i, 5.0 - 5.0 * np.cos(ang)])
        cams.append((R, -R @ C))
    return cams


def render_multiview_scene(image_dir: Path, n_cams: int = 8,
                           size: tuple[int, int] = (480, 640), focal: float = 600.0,
                           seed: int = 0, arc: float = 0.35):
    """Textured slanted planes seen by an arc of pinhole cameras, written as
    ``view_XXX.png`` with the poses in ``gt_poses.json`` beside them.
    Returns (cams, K): cams the world -> camera (R, t) of each view, K the
    shared intrinsics."""
    h, w = size
    rng = np.random.default_rng(seed)
    K = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]])
    planes = [(np.array(corners), make_structured_image(rng, n, n))
              for corners, n in PLANES]
    image_dir = Path(image_dir)
    image_dir.mkdir(parents=True, exist_ok=True)
    cams = arc_cameras(n_cams, arc)
    names = [f"view_{i:03d}.png" for i in range(n_cams)]
    for (R, t), name in zip(cams, names):
        img = np.zeros((h, w, 3), np.uint8)
        for corners, tex in planes:  # the far plane first
            Xc = corners @ R.T + t
            uv = (Xc[:, :2] / Xc[:, 2:]) * focal + np.array([w / 2, h / 2])
            th, tw = tex.shape[:2]
            src = np.array([[0, 0], [tw - 1, 0], [tw - 1, th - 1], [0, th - 1]],
                           np.float32)
            Hm = perspective_transform(src, uv.astype(np.float32))
            # The plane's coverage (a constant 255 warped) as a fourth channel.
            rgba = np.concatenate([tex, np.full((th, tw, 1), 255, np.uint8)], axis=-1)
            warped = warp_perspective(rgba, Hm, (w, h))
            cover = warped[..., 3] > 128
            img[cover] = warped[cover][:, :3]
        write_png(image_dir / name, img[..., ::-1])  # OpenCV writes BGR arrays
    save_gt_poses(image_dir / "gt_poses.json", cams, names)
    return cams, K
