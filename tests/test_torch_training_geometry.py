"""The port's orientation, homography and synthetic-pair modules against
the JAX package's, on the same numpy inputs from a seed.

Bounds: orientation angles within 1e-5 rad (1e-4 for the histogram peak);
homography helpers and warped token grids within 1e-5 (f32 on both sides),
validity masks equal; the random homographies, photometric jitter and the
resize / composition helpers bit for bit (numpy on both sides, the same
``Generator`` draws); warped pixels against ``cv2.warpPerspective`` within
its rounding (mean |diff| <= 0.5, max <= 8 at the border, as
``tests/test_torch_render.py``); the HPatches-layout tree: the same names
and homographies bit for bit, images as ``make_structured_image`` allows.
"""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_colmap_tpu.dataloader import homography_utils as jh
from vit_colmap_tpu.dataloader import synthetic_homography as jsh
from vit_colmap_tpu.utils import orientation as jo
from vit_colmap_tpu_torch.dataloader import homography_utils as th
from vit_colmap_tpu_torch.dataloader import synthetic_homography as tsh
from vit_colmap_tpu_torch.utils import orientation as to


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Small tensor operations on 1 intra-op thread: test workers
    share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _smooth_image(seed, B=2, H=30, W=40):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (B, H, W, 3)).astype(np.uint8)
    return np.stack([cv2.GaussianBlur(i, (0, 0), 1.5) for i in img])


def test_gray_and_gradients_match_jax():
    img = _smooth_image(0)
    jg = jo.rgb_to_gray(jnp.asarray(img))
    tg = to.rgb_to_gray(torch.from_numpy(img))
    np.testing.assert_allclose(_np(tg), np.asarray(jg), rtol=1e-6)
    for a, b in zip(to.compute_image_gradients(tg / 255.0),
                    jo.compute_image_gradients(jg / 255.0)):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-6)


@pytest.mark.parametrize("sigma", [1.0, 0.0])
def test_simple_orientation_matches_jax(sigma):
    gray = jo.rgb_to_gray(jnp.asarray(_smooth_image(1))) / 255.0
    rng = np.random.default_rng(2)
    # Interior points, points on the border and points outside it (clamped).
    kpts = np.concatenate([rng.uniform(0, [39, 29], (2, 20, 2)),
                           np.array([[[0, 0], [39, 29], [-3, 5], [45, 31]]] * 2)],
                          axis=1).astype(np.float32)
    ref = jo.compute_keypoint_orientations_simple(gray, jnp.asarray(kpts), sigma)
    out = to.compute_keypoint_orientations_simple(torch.from_numpy(np.array(gray)),
                                                  torch.from_numpy(kpts), sigma)
    np.testing.assert_allclose(_np(out), np.asarray(ref), atol=1e-5)


def test_orientation_atan2_branch_at_pi():
    """A gradient along -x with gy exactly 0 reads +pi in both packages,
    and a flat image reads 0 (atan2(0, 0))."""
    ramp = np.tile(np.linspace(1.0, 0.0, 20, dtype=np.float32), (1, 12, 1))
    flat = np.full((1, 12, 20), 0.5, np.float32)
    kpts = np.array([[[10.0, 6.0], [3.5, 2.0]]], np.float32)
    for gray, want in ((ramp, np.pi), (flat, 0.0)):
        ref = np.asarray(jo.compute_keypoint_orientations_simple(
            jnp.asarray(gray), jnp.asarray(kpts)))
        out = _np(to.compute_keypoint_orientations_simple(torch.from_numpy(gray),
                                                          torch.from_numpy(kpts)))
        np.testing.assert_array_equal(out, ref)
        np.testing.assert_allclose(out, want, atol=1e-6)


def test_blur_by_taps_is_gaussian_blur_summed_in_order():
    """The orientation's blur is ``ops/scoring.gaussian_blur`` within f32
    rounding (1e-6), and exactly constant on a constant image."""
    from vit_colmap_tpu_torch.ops.scoring import gaussian_blur

    x = torch.from_numpy(np.random.default_rng(9).standard_normal((2, 30, 40)).astype(np.float32))
    for sigma in (1.0, 1.6):
        assert (to.blur_by_taps(x, sigma) - gaussian_blur(x, sigma)).abs().max() <= 1e-6
    flat = to.blur_by_taps(torch.full((1, 20, 30), 0.37), 1.0)
    assert (flat == flat[0, 0, 0]).all()


def test_histogram_orientation_matches_jax():
    gray = jo.rgb_to_gray(jnp.asarray(_smooth_image(3, H=48, W=48))) / 255.0
    kpts = np.random.default_rng(4).uniform(10, 38, (2, 6, 2)).astype(np.float32)
    ref = jo.compute_keypoint_orientations_histogram(gray, jnp.asarray(kpts))
    out = to.compute_keypoint_orientations_histogram(torch.from_numpy(np.array(gray)),
                                                     torch.from_numpy(kpts))
    d = np.angle(np.exp(1j * (_np(out) - np.asarray(ref))))
    assert np.abs(d).max() <= 1e-4


def _homographies(seed, B=2, w=84, h=70):
    rng = np.random.default_rng(seed)
    cfg = jsh.SyntheticHomographyConfig.conservative()
    return np.stack([jsh.generate_random_homography(w, h, cfg, rng)
                     for _ in range(B)]).astype(np.float32)


def test_homography_helpers_match_jax():
    H = _homographies(5)
    pts = np.random.default_rng(6).uniform(0, 80, (2, 9, 2)).astype(np.float32)
    np.testing.assert_allclose(_np(th.apply_homography(torch.from_numpy(H),
                                                       torch.from_numpy(pts))),
                               np.asarray(jh.apply_homography(jnp.asarray(H),
                                                              jnp.asarray(pts))),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(_np(th.grid_centers(5, 6)), np.asarray(jh.grid_centers(5, 6)))
    g = th.image_to_grid(torch.from_numpy(pts))
    np.testing.assert_allclose(_np(g), np.asarray(jh.image_to_grid(jnp.asarray(pts))), rtol=1e-6)
    np.testing.assert_allclose(_np(th.grid_to_image(g)), pts, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        _np(th.compose_homographies(torch.from_numpy(H[0]), torch.from_numpy(H[1]))),
        np.asarray(jh.compose_homographies(jnp.asarray(H[0]), jnp.asarray(H[1]))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        _np(th.adjust_homography_for_resize(torch.from_numpy(H[0]), 0.5, 0.7, 1.5, 1.2)),
        np.asarray(jh.adjust_homography_for_resize(jnp.asarray(H[0]), 0.5, 0.7, 1.5, 1.2)),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(th.homography_rotation_angle(torch.from_numpy(H))),
                               np.asarray(jh.homography_rotation_angle(jnp.asarray(H))),
                               atol=1e-6)


def test_warp_and_similarity_match_jax():
    rng = np.random.default_rng(7)
    f1 = rng.standard_normal((2, 5, 6, 8)).astype(np.float32)
    f2 = rng.standard_normal((2, 5, 6, 8)).astype(np.float32)
    H = _homographies(8)
    jw, jv = jh.warp_patch_tokens(jnp.asarray(f1), jnp.asarray(H))
    tw, tv = th.warp_patch_tokens(torch.from_numpy(f1), torch.from_numpy(H))
    np.testing.assert_array_equal(_np(tv), np.asarray(jv))
    assert 0 < _np(tv).sum() < tv.numel()  # the border cuts some cells
    np.testing.assert_allclose(_np(tw), np.asarray(jw), atol=1e-5)
    js, jv = jh.feature_similarity_map(jnp.asarray(f1), jnp.asarray(f2), jnp.asarray(H))
    ts, tv = th.feature_similarity_map(torch.from_numpy(f1), torch.from_numpy(f2),
                                       torch.from_numpy(H))
    np.testing.assert_array_equal(_np(tv), np.asarray(jv))
    np.testing.assert_allclose(_np(ts), np.asarray(js), atol=1e-5)


@pytest.mark.parametrize("preset", ["conservative", "moderate", "aggressive"])
def test_random_homographies_bit_for_bit(preset):
    assert tsh.SyntheticHomographyConfig.preset(preset) == tsh.SyntheticHomographyConfig(
        **vars(jsh.SyntheticHomographyConfig.preset(preset)))
    ra, rb = np.random.default_rng(11), np.random.default_rng(11)
    for w, h in ((84, 70), (1600, 1200)):
        for _ in range(3):
            np.testing.assert_array_equal(
                tsh.generate_random_homography(w, h, tsh.SyntheticHomographyConfig.preset(preset), rb),
                jsh.generate_random_homography(w, h, jsh.SyntheticHomographyConfig.preset(preset), ra))
    assert ra.random() == rb.random()


def test_synthetic_pair_and_jitter_match_jax():
    img = _smooth_image(12, B=1, H=60, W=80)[0]
    ra, rb = np.random.default_rng(13), np.random.default_rng(13)
    jw, jH = jsh.create_synthetic_pair(img, None, ra)
    tw, tH = tsh.create_synthetic_pair(img, None, rb)
    np.testing.assert_array_equal(tH, jH)
    d = np.abs(tw.astype(int) - jw.astype(int))
    assert d.mean() <= 0.5 and d.max() <= 8, (d.mean(), d.max())
    np.testing.assert_array_equal(tsh.photometric_jitter(img, rb, 0.7),
                                  jsh.photometric_jitter(img, ra, 0.7))
    np.testing.assert_array_equal(tsh.photometric_jitter(img, rb, 0.0), img)
    jsh.photometric_jitter(img, ra, 0.0)
    assert ra.random() == rb.random()
    np.testing.assert_array_equal(
        tsh.adjust_homography_for_resize(jH, (80, 60), (70, 56), (90, 66), (70, 56)),
        jsh.adjust_homography_for_resize(jH, (80, 60), (70, 56), (90, 66), (70, 56)))
    np.testing.assert_array_equal(tsh.compose_homographies(jH, tH.T),
                                  jsh.compose_homographies(jH, tH.T))


def test_synthetic_hpatches_tree_matches_jax(tmp_path):
    from vit_colmap_tpu.dataloader.synthetic_benchmark import (
        generate_synthetic_hpatches as jgen,
    )
    from vit_colmap_tpu_torch.dataloader.synthetic_benchmark import (
        generate_synthetic_hpatches as tgen,
    )
    from vit_colmap_tpu_torch.utils.image_io import imread_rgb

    kw = dict(n_illum=1, n_view=2, n_img=3, size=(60, 80), seed=3)
    names = jgen(tmp_path / "jax", **kw)
    assert tgen(tmp_path / "torch", **kw) == names
    for name in names:
        files = sorted(p.name for p in (tmp_path / "jax" / name).iterdir())
        assert sorted(p.name for p in (tmp_path / "torch" / name).iterdir()) == files
        for f in files:
            a, b = tmp_path / "jax" / name / f, tmp_path / "torch" / name / f
            if f.startswith("H_"):
                np.testing.assert_array_equal(np.loadtxt(b), np.loadtxt(a))
                continue
            # cv2 reads the port's PPM as it reads its own (BGR order).
            ref = cv2.imread(str(a))
            assert (cv2.imread(str(b)) == imread_rgb(b)[..., ::-1]).all()
            d = np.abs(imread_rgb(b)[..., ::-1].astype(int) - ref.astype(int))
            assert d.shape == (60, 80, 3) and d.mean() <= 2.0, (name, f, d.mean())
