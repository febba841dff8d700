"""``ops/cv_detectors.py`` against OpenCV on the CPU.

Three seeded 240 x 320 images (``make_structured_image``; the third warped
by a rotation and scale), gray by ``cvtColor``.  Bars:

* FAST: points, responses and order equal.
* GFTT: points, responses and order equal, apart from ties at the cut
  (rows whose response equals the last kept one), at most 1% of rows.
* SIFT and ORB: keypoint counts within 2%; at least 95% of OpenCV's
  distinct points have a port point within 0.05 px, and the reverse; the
  responses of matched points agree within 1e-4 relative.

One known-wrong variant per detector misses its bar: SIFT without the x2
base, FAST with the 7-of-12 segment test, GFTT with the Harris score, ORB
without the pyramid.
"""

import cv2
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from vit_colmap_tpu_torch.dataloader.synthetic_benchmark import make_structured_image
from vit_colmap_tpu_torch.ops import cv_detectors as cd
from vit_colmap_tpu_torch.utils.image_io import rgb_to_gray

torch.set_num_threads(2)

H, W = 240, 320
N_FEATURES = 4096
KP_TOL = 0.05
KP_SHARE = 0.95
COUNT_REL = 0.02
RESP_REL = 1e-4
TIE_SHARE = 0.01


def _gray(seed: int) -> np.ndarray:
    rgb = make_structured_image(np.random.default_rng(seed), H, W)
    if seed == 2:
        M = cv2.getRotationMatrix2D((W / 2, H / 2), 17, 0.9)
        rgb = cv2.warpAffine(rgb, M, (W, H), borderMode=cv2.BORDER_REFLECT)
    return cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY)


IMAGES = {s: _gray(s) for s in range(3)}


def _cv(kps):
    return (np.array([k.pt for k in kps], np.float32).reshape(-1, 2),
            np.array([k.response for k in kps], np.float32))


def _port(out):
    return out[0].numpy(), out[1].numpy()


def cv_reference(name: str, gray: np.ndarray):
    if name == "sift":
        return _cv(cv2.SIFT_create(nfeatures=N_FEATURES).detect(gray))
    if name == "orb":
        return _cv(cv2.ORB_create(nfeatures=N_FEATURES).detect(gray))
    if name == "gftt":
        return _cv(cv2.GFTTDetector_create(maxCorners=N_FEATURES).detect(gray))
    return _cv(cv2.FastFeatureDetector_create().detect(gray))


def point_bar_misses(ref, out) -> list[str]:
    """SIFT's and ORB's bar: the bars that ``out`` misses against ``ref``."""
    (rp, rr), (p, r) = ref, out
    misses = []
    if abs(len(p) - len(rp)) > COUNT_REL * len(rp):
        misses.append(f"count {len(p)} vs {len(rp)}")
    if len(p) == 0:
        return misses + ["no points"]
    ur, up = np.unique(rp, axis=0), np.unique(p, axis=0)
    share_ref = (cKDTree(up).query(ur)[0] <= KP_TOL).mean()
    share_out = (cKDTree(ur).query(up)[0] <= KP_TOL).mean()
    if share_ref < KP_SHARE or share_out < KP_SHARE:
        misses.append(f"points within {KP_TOL} px: {share_ref:.3f} / {share_out:.3f}")
    # responses: each reference keypoint against the closest response among
    # the port's keypoints at its point (a point can carry several)
    tree = cKDTree(p)
    rel = []
    for q, resp in zip(rp, rr):
        near = tree.query_ball_point(q, KP_TOL)
        if near:
            rel.append(np.min(np.abs(r[near] - resp)) / max(abs(float(resp)), 1e-30))
    if rel and max(rel) > RESP_REL:
        misses.append(f"response relative error {max(rel):.2e}")
    return misses


def exact_bar_misses(ref, out) -> list[str]:
    """FAST's bar: points, responses and order equal."""
    (rp, rr), (p, r) = ref, out
    if p.shape != rp.shape or not np.array_equal(p, rp) or not np.array_equal(r, rr):
        return [f"not equal ({len(p)} vs {len(rp)} points)"]
    return []


def gftt_bar_misses(ref, out) -> list[str]:
    """GFTT's bar: equal rows in order, apart from ties at the cut."""
    (rp, rr), (p, r) = ref, out
    if len(p) != len(rp):
        return [f"count {len(p)} vs {len(rp)}"]
    differ = ~((p == rp).all(1) & (r == rr))
    tie = rr == rr[-1] if len(rr) else differ
    if (differ & ~tie).any():
        return [f"{int((differ & ~tie).sum())} rows differ before the cut"]
    if differ.sum() > TIE_SHARE * len(rp):
        return [f"{int(differ.sum())} tied rows differ at the cut"]
    return []


@pytest.mark.parametrize("seed", sorted(IMAGES))
def test_fast_equals_opencv(seed):
    g = IMAGES[seed]
    ref = cv_reference("fast", g)
    assert len(ref[0]) > 100
    assert exact_bar_misses(ref, _port(cd.detect_fast(torch.from_numpy(g)))) == []


@pytest.mark.parametrize("seed", sorted(IMAGES))
def test_gftt_equals_opencv(seed):
    g = IMAGES[seed]
    ref = cv_reference("gftt", g)
    assert len(ref[0]) > 100
    assert gftt_bar_misses(ref, _port(cd.detect_gftt(torch.from_numpy(g), N_FEATURES))) == []


@pytest.mark.parametrize("seed", sorted(IMAGES))
def test_orb_meets_bar(seed):
    g = IMAGES[seed]
    ref = cv_reference("orb", g)
    assert len(ref[0]) > 100
    assert point_bar_misses(ref, _port(cd.detect_orb(torch.from_numpy(g), N_FEATURES))) == []


@pytest.mark.parametrize("seed", sorted(IMAGES))
def test_sift_meets_bar(seed):
    g = IMAGES[seed]
    ref = cv_reference("sift", g)
    assert len(ref[0]) > 100
    assert point_bar_misses(ref, _port(cd.detect_sift(torch.from_numpy(g), N_FEATURES))) == []


@pytest.mark.parametrize("name", ["sift", "fast", "gftt", "orb"])
def test_known_wrong_variant_misses_bar(name):
    g = IMAGES[0]
    t = torch.from_numpy(g)
    ref = cv_reference(name, g)
    if name == "sift":
        misses = point_bar_misses(ref, _port(cd.detect_sift(t, N_FEATURES, upsample=False)))
    elif name == "fast":
        misses = exact_bar_misses(ref, _port(cd.detect_fast(t, pattern="7_12")))
    elif name == "gftt":
        misses = gftt_bar_misses(ref, _port(cd.detect_gftt(t, N_FEATURES, use_harris=True)))
    else:
        misses = point_bar_misses(ref, _port(cd.detect_orb(t, N_FEATURES, pyramid=False)))
    assert misses


def test_gftt_ties_break_by_descending_address():
    """Equal responses come out in descending row-major order (OpenCV's
    ``greaterThanPtr`` compares addresses): a flat image with four equal
    corners."""
    g = np.full((40, 48), 50, np.uint8)
    for y, x in ((10, 10), (10, 30), (28, 10), (28, 30)):
        g[y : y + 6, x : x + 6] = 200
    ref = cv_reference("gftt", g)
    p, r = _port(cd.detect_gftt(torch.from_numpy(g), N_FEATURES))
    np.testing.assert_array_equal(p, ref[0])
    np.testing.assert_array_equal(r, ref[1])
    top = r == r[0]
    assert top.sum() > 1
    addr = p[top, 1] * 48 + p[top, 0]
    assert (np.diff(addr) < 0).all()


def test_gftt_min_distance_grid():
    g = IMAGES[1]
    ref = _cv(cv2.GFTTDetector_create(500, 0.01, 7.5, 3).detect(g))
    out = _port(cd.detect_gftt(torch.from_numpy(g), 500, min_distance=7.5))
    np.testing.assert_array_equal(out[0], ref[0])
    np.testing.assert_array_equal(out[1], ref[1])


@pytest.mark.parametrize("width", [20, 31, 47, 65, 319, 323])
def test_corner_min_eigen_val_bit_exact(width):
    """Both sides of the row filter's 32-column split."""
    g = cv2.cvtColor(make_structured_image(np.random.default_rng(width), 37, width),
                     cv2.COLOR_RGB2GRAY)
    ref = cv2.cornerMinEigenVal(g, 3, 3)
    np.testing.assert_array_equal(cd.corner_min_eigen_val(torch.from_numpy(g)).numpy(), ref)


@pytest.mark.parametrize("size", [(266, 222), (200, 167), (11, 9), (240, 320)])
def test_resize_linear_exact_bit_exact(size):
    g = IMAGES[1]
    w, h = size
    ref = cv2.resize(g, (w, h), interpolation=cv2.INTER_LINEAR_EXACT)
    np.testing.assert_array_equal(cd.resize_linear_exact(torch.from_numpy(g), w, h).numpy(), ref)


def test_orb_pyramid_levels_match_opencv_resizes():
    levels = cd.orb_level_sizes(H, W, 8, 1.2)
    img = IMAGES[0]
    t = torch.from_numpy(img)
    for _scale, h, w in levels[1:]:
        img = cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR_EXACT)
        t = cd.resize_linear_exact(t, w, h)
        np.testing.assert_array_equal(t.numpy(), img)
    assert sum(cd.orb_features_per_level(N_FEATURES, 8, 1.2)) == N_FEATURES


@pytest.mark.parametrize("sigma", [0.5, 1.2489996, 1.6, 2.4525, 3.09])
def test_gaussian_taps_match_opencv(sigma):
    n = cd.gaussian_ksize(sigma)
    ref = cv2.getGaussianKernel(n, sigma, cv2.CV_32F).ravel()
    np.testing.assert_array_equal(cd.gaussian_taps(n, sigma), ref)


def test_upsample_and_blur_match_opencv():
    g = IMAGES[0].astype(np.float32)
    up = cv2.resize(g, (2 * W, 2 * H), interpolation=cv2.INTER_LINEAR)
    t = cd.upsample2x_linear(torch.from_numpy(g))
    np.testing.assert_array_equal(t.numpy(), up)
    ref = cv2.GaussianBlur(up, (0, 0), 1.2489996)
    out = cd.gaussian_blur_f32(t, 1.2489996).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("n,pad", [(5, 2), (3, 7), (1, 4), (2, 5)])
def test_reflect101_index_matches_border_interpolate(n, pad):
    ref = [cv2.borderInterpolate(p, n, cv2.BORDER_REFLECT_101) for p in range(-pad, n + pad)]
    np.testing.assert_array_equal(cd.reflect101_index(n, pad), ref)


def test_fast_atan2_matches_opencv():
    rng = np.random.default_rng(4)
    y, x = rng.standard_normal((2, 1000)).astype(np.float32) * 50
    ref = cv2.phase(x, y, angleInDegrees=True).ravel()
    out = cd.fast_atan2_deg(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-3)


def test_rgb_to_gray_matches_cvtcolor():
    rgb = np.random.default_rng(5).integers(0, 256, (64, 80, 3), dtype=np.uint8)
    np.testing.assert_array_equal(rgb_to_gray(rgb), cv2.cvtColor(rgb, cv2.COLOR_RGB2GRAY))
