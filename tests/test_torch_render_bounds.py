"""The port's renderer fills only a bounding box of each shape
(``_box``, with ``_convex_margin`` for polygons).  Held here bit for bit
against the same fills evaluated over the whole image, on random
polygons (thick lines' quadrilaterals among them), thin ones whose
widened edges reach far past their vertices, ones clipped at the
border, and rings."""

import numpy as np
import pytest

from vit_colmap_tpu_torch.dataloader import synthetic_benchmark as render

H, W = 48, 64


def _full_convex(img, pts, color):
    """The polygon fill over every pixel of the image."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    p = pts.astype(np.float64)
    side = []
    for i in range(len(p)):
        a, b = p[i], p[(i + 1) % len(p)]
        edge = max(float(np.hypot(*(b - a))), 1e-9)
        side.append(((b[0] - a[0]) * (yy - a[1]) - (b[1] - a[1]) * (xx - a[0])) / edge)
    s = np.stack(side)
    img[(s >= -0.5).all(0) | (s <= 0.5).all(0)] = color


def _full_ring(img, center, radius, color, thickness):
    """The ring fill over every pixel of the image."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    d = np.hypot(xx - center[0], yy - center[1])
    img[np.abs(d - radius) <= 0.75 * thickness] = color


def _polygons(kind: str, rng: np.random.Generator):
    if kind == "triangle":  # integer vertices, as fill_triangle gets them
        return rng.integers(-10, max(H, W) + 10, (3, 2))
    if kind == "thin":  # a sliver: the third vertex near the first edge
        a, b = rng.uniform(-10, W + 10, 2), rng.uniform(-10, W + 10, 2)
        n = np.array([-(b - a)[1], (b - a)[0]]) / max(np.hypot(*(b - a)), 1e-9)
        return np.stack([a, b, rng.uniform(0, 1) * a + (1 - rng.uniform(0, 1)) * b
                         + n * rng.uniform(-1.5, 1.5)])
    if kind == "line":  # a thick line's quadrilateral, as draw_line builds it
        a, b = rng.uniform(-8, W + 8, 2), rng.uniform(-8, W + 8, 2)
        d = b - a
        n = np.array([-d[1], d[0]]) / max(np.hypot(*d), 1e-9) * rng.uniform(0.5, 4.0)
        return np.array([a + n, a - n, b - n, b + n])
    # clipped: a convex polygon whose vertices lie mostly outside the image
    c = rng.uniform(-20, W + 20, 2)
    ang = np.sort(rng.uniform(0, 2 * np.pi, int(rng.integers(3, 7))))
    return c + rng.uniform(10, 60) * np.stack([np.cos(ang), np.sin(ang)], 1)


@pytest.mark.parametrize("kind", ["triangle", "thin", "line", "clipped"])
def test_bounded_convex_fill_equals_the_full_image_fill(kind):
    rng = np.random.default_rng(["triangle", "thin", "line", "clipped"].index(kind))
    for _ in range(200):
        pts = _polygons(kind, rng)
        got = np.zeros((H, W, 3), np.uint8)
        want = np.zeros((H, W, 3), np.uint8)
        render._fill_convex(got, pts, (200, 100, 50))
        _full_convex(want, pts, (200, 100, 50))
        assert np.array_equal(got, want), pts


def test_bounded_ring_equals_the_full_image_ring():
    rng = np.random.default_rng(7)
    for _ in range(200):
        center = tuple(int(v) for v in rng.integers(-20, W + 20, 2))
        radius, thickness = int(rng.integers(0, 40)), int(rng.integers(1, 6))
        got = np.zeros((H, W, 3), np.uint8)
        want = np.zeros((H, W, 3), np.uint8)
        render.fill_circle(got, center, radius, (9, 8, 7), thickness)
        _full_ring(want, center, radius, (9, 8, 7), thickness)
        assert np.array_equal(got, want), (center, radius, thickness)
