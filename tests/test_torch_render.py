"""The port's numpy renderer (``vit_colmap_tpu_torch/dataloader/
synthetic_benchmark.py``) against the JAX package's OpenCV renderer, and
the port's gray reader against ``cv2.imread(IMREAD_GRAYSCALE)``.

The renderers draw the same random numbers in the same order, so the
layout (shapes, colours, planes, cameras) is the reference's and the
poses are equal bit for bit.  The pixels are not: rings, thick lines and
the edge pixels of shapes and planes are rasterized differently.  Bounds
on the absolute difference of the uint8 pixels (the per-piece numbers are
what these functions give against OpenCV 5.0): a structured image at 480 x
640 mean <= 0.5 and 99th percentile <= 12; a rendered view at 120 x 160
mean <= 3 and 99th percentile <= 60 (the small view makes edges a large
share of its pixels); cubic upsampling within 1e-5; the blur within 1
level; the perspective transform within 1e-9; the warp of a noise texture
(where a 1/32-pixel rounding step shows most) mean <= 0.5, max <= 8.
"""

import json

import cv2
import numpy as np
import pytest

from vit_colmap_tpu.dataloader import synthetic_benchmark as jrender
from vit_colmap_tpu_torch.dataloader import synthetic_benchmark as trender
from vit_colmap_tpu_torch.utils.image_io import imread_gray, write_png


def _diff(a, b):
    d = np.abs(a.astype(int) - b.astype(int))
    return d.mean(), np.percentile(d, 99)


def test_structured_image_follows_the_reference():
    ra, rb = np.random.default_rng(3), np.random.default_rng(3)
    a = jrender.make_structured_image(ra, 480, 640)
    b = trender.make_structured_image(rb, 480, 640)
    assert a.shape == b.shape and a.dtype == b.dtype
    mean, p99 = _diff(a, b)
    assert mean <= 0.5 and p99 <= 12, (mean, p99)
    assert ra.random() == rb.random()  # the same draws, in the same order


def test_scene_follows_the_reference(tmp_path):
    kw = dict(n_cams=3, size=(120, 160), focal=150.4, seed=7)
    jcams, jK = jrender.render_multiview_scene(tmp_path / "jax", **kw)
    tcams, tK = trender.render_multiview_scene(tmp_path / "torch", **kw)
    np.testing.assert_array_equal(tK, jK)
    for (Rj, tj), (Rt, tt) in zip(jcams, tcams):
        np.testing.assert_array_equal(Rt, Rj)
        np.testing.assert_array_equal(tt, tj)
    assert ((tmp_path / "torch/gt_poses.json").read_text()
            == (tmp_path / "jax/gt_poses.json").read_text())
    assert json.loads((tmp_path / "torch/gt_poses.json").read_text()).keys() == {
        "view_000.png", "view_001.png", "view_002.png"}
    for i in range(3):
        a = cv2.imread(str(tmp_path / f"jax/view_{i:03d}.png"))
        b = cv2.imread(str(tmp_path / f"torch/view_{i:03d}.png"))
        assert a.shape == b.shape == (120, 160, 3)
        mean, p99 = _diff(a, b)
        assert mean <= 3 and p99 <= 60, (i, mean, p99)


def test_pieces_match_opencv():
    rng = np.random.default_rng(0)
    small = rng.random((12, 16, 3)).astype(np.float32)
    np.testing.assert_allclose(
        trender.resize_cubic(small, 640, 480),
        cv2.resize(small, (640, 480), interpolation=cv2.INTER_CUBIC), atol=1e-5)
    img = rng.integers(0, 256, (50, 60, 3)).astype(np.uint8)
    assert np.abs(trender.gaussian_blur_u8(img).astype(int)
                  - cv2.GaussianBlur(img, (0, 0), 1.0)).max() <= 1
    src = np.array([[0, 0], [383, 0], [383, 383], [0, 383]], np.float32)
    dst = np.array([[100, 50], [400, 80], [380, 400], [90, 420]], np.float32)
    H = cv2.getPerspectiveTransform(src, dst)
    np.testing.assert_allclose(trender.perspective_transform(src, dst), H, atol=1e-9)
    tex = rng.integers(0, 256, (384, 384, 3)).astype(np.uint8)
    d = np.abs(trender.warp_perspective(tex, H, (640, 480)).astype(int)
               - cv2.warpPerspective(tex, H, (640, 480)))
    assert d.mean() <= 0.5 and d.max() <= 8, (d.mean(), d.max())
    for c, r in (((100, 100), 30), ((3, 190), 20)):
        a = np.zeros((200, 200, 3), np.uint8)
        b = a.copy()
        cv2.circle(a, c, r, (255, 255, 255), -1)
        trender.fill_circle(b, c, r, (255, 255, 255), -1)
        np.testing.assert_array_equal(b, a)  # the disc is OpenCV's exactly
    a = np.zeros((200, 200, 3), np.uint8)
    b = a.copy()
    pts = np.array([[10, 20], [150, 60], [70, 180]], np.int32)
    cv2.fillPoly(a, [pts], (255, 255, 255))
    trender.fill_triangle(b, pts, (255, 255, 255))
    np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("kind", ["rgb_png", "rgba_png", "gray_png", "ppm", "pgm"])
def test_imread_gray_matches_opencv(tmp_path, kind):
    rng = np.random.default_rng(11)
    img = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    img[:5] = img[:5, :, :1]  # grey rows pass through unchanged
    path = tmp_path / ("img.ppm" if kind == "ppm" else "img.pgm" if kind == "pgm"
                       else "img.png")
    if kind == "rgb_png":
        write_png(path, img)
    elif kind == "rgba_png":
        cv2.imwrite(str(path), np.concatenate([img[..., ::-1], img[..., :1]], axis=-1))
    elif kind == "gray_png":
        write_png(path, img[..., 0])
    elif kind == "ppm":
        cv2.imwrite(str(path), img[..., ::-1])
    else:
        cv2.imwrite(str(path), img[..., 0])
    ref = cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
    np.testing.assert_array_equal(imread_gray(path), ref)
