"""The port's SIFT (``vit_colmap_tpu_torch/ops/sift.py``) against the JAX
package's, stage by stage, on the same numpy inputs, on the CPU.

Inputs: B = 2 smooth random images (cubic-upsampled noise) of 96 x 128 and
120 x 160, and flat-coloured images whose |DoG| values tie.  Bounds, where
the two packages' blurs and contractions round differently (a few ulps of
the DoG, which the refinement's division amplifies):

* scale space and gradients: within 1e-5 (values in [0, 1]);
* extrema: equal indices, scales, scores within 1e-6;
* refinement: positions and scales within 2e-3 where both keep a point,
  validity equal;
* orientations: within 5e-3 rad at 99% of the keypoints (a peak that moves
  a bin shows as up to 0.2 rad at the rest);
* descriptors: 99% of the bytes within 1 level, every one within 16;
* ``extract_sift``: the same number of keypoints, positions within 2e-3 px,
  scales within 2e-3, orientations and descriptors as above.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_colmap_tpu.ops import sift as jsift
from vit_colmap_tpu_torch.ops import sift as tsift


def _smooth(seed: int, h: int, w: int, b: int = 2) -> np.ndarray:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(b):
        small = rng.random((h // 8, w // 8)).astype(np.float32)
        out.append(np.clip(cv2.resize(small, (w, h), interpolation=cv2.INTER_CUBIC), 0, 1))
    return np.stack(out)


def _flat(h: int = 96, w: int = 128) -> np.ndarray:
    """Flat-coloured rectangles on a flat background, two of them alike, so
    that equal |DoG| values appear at several places."""
    img = np.full((2, h, w), 0.2, np.float32)
    img[:, 20:40, 20:44] = 0.9
    img[:, 50:70, 70:94] = 0.9
    img[1, 30:60, 100:120] = 0.6
    return img


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x))


IMAGES = {"96x128": _smooth(0, 96, 128), "120x160": _smooth(1, 120, 160),
          "flat": _flat()}


def _octave(name):
    g = IMAGES[name]
    jg, jd = jsift.build_octave(jnp.asarray(g), num_scales=3)
    tg, td = tsift.build_octave(_t(g), num_scales=3)
    return (np.asarray(jg), np.asarray(jd)), (tg, td)


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_build_octave_matches_jax(name):
    (jg, jd), (tg, td) = _octave(name)
    assert tg.shape == jg.shape and td.shape == jd.shape
    np.testing.assert_allclose(tg.numpy(), jg, atol=1e-5)
    np.testing.assert_allclose(td.numpy(), jd, atol=1e-5)


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_find_extrema_matches_jax(name):
    """On the JAX package's own DoG: the same indices in the same order
    (ties included), the same scores and validity."""
    (_, jd), _ = _octave(name)
    ref = [np.asarray(a) for a in jsift.find_extrema(jnp.asarray(jd), k_per_octave=64)]
    out = [a.numpy() for a in tsift.find_extrema(_t(jd), k_per_octave=64)]
    np.testing.assert_array_equal(out[0], ref[0])
    np.testing.assert_array_equal(out[1], ref[1])
    np.testing.assert_allclose(out[2], ref[2], atol=1e-6)
    np.testing.assert_array_equal(out[3], ref[3])
    assert ref[3].any()


def test_flat_image_ties_keep_the_lower_index():
    """Flat-coloured shapes give equal scores; both packages rank them by
    index, and top_k_first is lax.top_k's order on any values."""
    (_, jd), _ = _octave("flat")
    score = np.where(np.abs(jd) > 0.001, np.round(np.abs(jd), 3), 0.0).reshape(2, -1)
    score = score.astype(np.float32)
    assert len(np.unique(score[score > 0])) < (score > 0).sum()  # ties exist
    ref_v, ref_i = jax.lax.top_k(jnp.asarray(score), 500)
    v, i = tsift.top_k_first(_t(score), 500)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(v.numpy(), np.asarray(ref_v))
    mixed = np.array([[0.5, -1.0, 0.5, -np.inf, -1.0, 0.0, -0.0, 2.0]], np.float32)
    rv, ri = jax.lax.top_k(jnp.asarray(mixed), 8)
    v, i = tsift.top_k_first(_t(mixed), 8)
    np.testing.assert_array_equal(i.numpy()[:, :5], np.asarray(ri)[:, :5])
    np.testing.assert_array_equal(v.numpy(), np.asarray(rv))


@pytest.mark.parametrize("name", ["96x128", "120x160"])
def test_refine_extrema_matches_jax(name):
    (_, jd), _ = _octave(name)
    xy, s_idx, _, valid = jsift.find_extrema(jnp.asarray(jd), k_per_octave=64)
    ref = [np.asarray(a) for a in jsift.refine_extrema(jnp.asarray(jd), xy, s_idx, valid)]
    out = [a.numpy() for a in tsift.refine_extrema(
        _t(jd), _t(xy), _t(s_idx).long(), _t(valid))]
    np.testing.assert_array_equal(out[2], ref[2])
    keep = ref[2]
    np.testing.assert_allclose(out[0][keep], ref[0][keep], atol=2e-3)
    np.testing.assert_allclose(out[1][keep], ref[1][keep], atol=2e-3)


def _keypoints(name, k=48):
    """Refined keypoints on the JAX package's octave, with their levels and
    sigmas, and the level-stacked gradient maps of both packages."""
    (jg, jd), _ = _octave(name)
    xy, s_idx, _, valid = jsift.find_extrema(jnp.asarray(jd), k_per_octave=k)
    xy, s_ref, valid = jsift.refine_extrema(jnp.asarray(jd), xy, s_idx, valid)
    level = np.clip(np.round(np.asarray(s_ref)).astype(np.int32), 0, 5)
    sigma = (tsift.SIGMA0 * np.power(2.0 ** (1 / 3), np.asarray(s_ref))).astype(np.float32)
    B, L, H, W = jg.shape
    jfm = np.asarray(jsift._gradient_fm(jnp.asarray(jg))).reshape(B, L * H, W, 2)
    tfm = tsift._gradient_fm(_t(jg)).reshape(B, L * H, W, 2)
    return dict(xy=np.asarray(xy), level=level, sigma=sigma, valid=np.asarray(valid),
                jfm=jfm, tfm=tfm, H=H, W=W, gauss=jg)


def _angles_close(a, b, share=0.99, tol=5e-3):
    d = np.abs(np.angle(np.exp(1j * (a.astype(np.float64) - b))))
    assert d.size == 0 or (d <= tol).mean() >= share, np.sort(d)[-5:]


def _bytes_close(a, b):
    d = np.abs(a.astype(int) - b.astype(int))
    assert d.size == 0 or ((d <= 1).mean() >= 0.99 and d.max() <= 16), (d.max(), (d <= 1).mean())


@pytest.mark.parametrize("name", ["96x128", "120x160"])
def test_gradient_maps_match_jax(name):
    kp = _keypoints(name)
    np.testing.assert_allclose(kp["tfm"][..., 0].numpy(), kp["jfm"][..., 0], atol=1e-5)
    _angles_close(kp["tfm"][..., 1].numpy(), kp["jfm"][..., 1], share=0.999, tol=1e-4)


@pytest.mark.parametrize("name", ["96x128", "120x160"])
def test_orientations_match_jax(name):
    kp = _keypoints(name)
    args = (kp["xy"], kp["level"], kp["sigma"])
    ref = np.asarray(jsift.dominant_orientation_multilevel(
        jnp.asarray(kp["jfm"]), *(jnp.asarray(a) for a in args), kp["H"], kp["W"]))
    out = tsift.dominant_orientation_multilevel(
        _t(kp["jfm"]), _t(args[0]), _t(args[1]).long(), _t(args[2]), kp["H"], kp["W"])
    _angles_close(out.numpy(), ref)
    ref_a, ref_ok = (np.asarray(a) for a in jsift.orientation_peaks_multilevel(
        jnp.asarray(kp["jfm"]), *(jnp.asarray(a) for a in args), kp["H"], kp["W"]))
    out_a, out_ok = tsift.orientation_peaks_multilevel(
        _t(kp["jfm"]), _t(args[0]), _t(args[1]).long(), _t(args[2]), kp["H"], kp["W"])
    assert (out_ok.numpy() == ref_ok).mean() >= 0.99
    both = ref_ok & out_ok.numpy()
    _angles_close(out_a.numpy()[both], ref_a[both])
    g = kp["gauss"][:, 2]
    ref1 = np.asarray(jsift.dominant_orientation(jnp.asarray(g), jnp.asarray(kp["xy"])))
    out1 = tsift.dominant_orientation(_t(g), _t(kp["xy"]))
    _angles_close(out1.numpy(), ref1)


@pytest.mark.parametrize("name", ["96x128", "120x160"])
def test_descriptors_match_jax(name):
    """Both descriptor functions on the same keypoints and orientations."""
    kp = _keypoints(name)
    rng = np.random.default_rng(5)
    orient = rng.uniform(-np.pi, np.pi, kp["level"].shape).astype(np.float32)
    win = (tsift.DESC_BIN_SIGMA * 4.0 * kp["sigma"]).astype(np.float32)
    ref = np.asarray(jsift.sift_descriptors_multilevel(
        jnp.asarray(kp["jfm"]), jnp.asarray(kp["xy"]), jnp.asarray(kp["level"]),
        jnp.asarray(orient), jnp.asarray(win), kp["H"], kp["W"]))
    out = tsift.sift_descriptors_multilevel(
        _t(kp["jfm"]), _t(kp["xy"]), _t(kp["level"]).long(), _t(orient), _t(win),
        kp["H"], kp["W"])
    assert out.dtype == torch.uint8 and out.shape == ref.shape
    _bytes_close(out.numpy(), ref)
    g = kp["gauss"][:, 1]
    ref1 = np.asarray(jsift.sift_descriptors(jnp.asarray(g), jnp.asarray(kp["xy"]),
                                             jnp.asarray(orient), jnp.asarray(win)))
    out1 = tsift.sift_descriptors(_t(g), _t(kp["xy"]), _t(orient), _t(win))
    _bytes_close(out1.numpy(), ref1)


def _hold(ref, out):
    (kj, dj), (kt, dt) = ref, out
    assert len(kj) == len(kt) == 2 and len(kj[0]) + len(kj[1]) > 0
    for b in range(2):
        assert kt[b].shape == kj[b].shape and dt[b].dtype == np.uint8
        np.testing.assert_allclose(kt[b][:, :3], kj[b][:, :3], atol=2e-3)
        _angles_close(kt[b][:, 3], kj[b][:, 3])
        _bytes_close(dt[b], dj[b])


@pytest.mark.parametrize("num_orientations", [1, 2])
@pytest.mark.parametrize("first_octave", [-1, 0])
@pytest.mark.parametrize("name", ["96x128", "120x160"])
def test_extract_sift_matches_jax(name, first_octave, num_orientations):
    g = IMAGES[name]
    kw = dict(max_keypoints=128, first_octave=first_octave,
              num_orientations=num_orientations)
    _hold(jsift.extract_sift(g, **kw), tsift.extract_sift(g, device="cpu", **kw))


def test_extract_sift_uint8_input_matches_jax():
    u8 = (IMAGES["120x160"] * 255.0).round().astype(np.uint8)
    _hold(jsift.extract_sift(u8, max_keypoints=128),
          tsift.extract_sift(u8, max_keypoints=128, device="cpu"))


def test_extract_sift_flat_image_matches_jax():
    """Tied scores through the whole program: the same keypoints."""
    g = IMAGES["flat"]
    _hold(jsift.extract_sift(g, max_keypoints=64), tsift.extract_sift(g, max_keypoints=64,
                                                                      device="cpu"))


def test_upsample_equals_jax_resize():
    g = IMAGES["96x128"]
    ref = np.asarray(jax.image.resize(jnp.asarray(g), (2, 192, 256), "linear"))
    np.testing.assert_allclose(tsift.upsample2x(_t(g)).numpy(), ref, atol=1e-6)


# -- the cases of tests/test_sift.py, on the port ---------------------------


def _blob_image(h=128, w=128, centers=((40, 40), (90, 60), (60, 100)), sigma=3.0):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w), np.float32)
    for cy, cx in centers:
        img += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sigma**2))
    return img / img.max()


def test_octave_shapes():
    gauss, dog = tsift.build_octave(torch.zeros(2, 64, 64), num_scales=3)
    assert gauss.shape == (2, 6, 64, 64) and dog.shape == (2, 5, 64, 64)


def test_extrema_found_at_blobs():
    _, dog = tsift.build_octave(_t(_blob_image()[None]), num_scales=3)
    xy, _, _, valid = tsift.find_extrema(dog, k_per_octave=32)
    found = xy[0][valid[0]].numpy()
    assert len(found) >= 3
    for cy, cx in ((40, 40), (90, 60), (60, 100)):
        assert np.linalg.norm(found - np.array([cx, cy]), axis=1).min() < 4.0


def test_extract_sift_full():
    kpts, descs = tsift.extract_sift(_blob_image()[None], max_keypoints=128, device="cpu")
    kp, dc = kpts[0], descs[0]
    assert kp.shape[1] == 4 and dc.shape == (len(kp), 128) and dc.dtype == np.uint8
    assert len(kp) >= 3
    assert (kp[:, 0] >= 0).all() and (kp[:, 0] < 128).all()


def test_extract_sift_uint8_wire_equals_float():
    u8 = (_blob_image() * 255.0).round().astype(np.uint8)
    kp_f, dc_f = tsift.extract_sift(u8.astype(np.float32)[None] / 255.0,
                                    max_keypoints=128, device="cpu")
    kp_u, dc_u = tsift.extract_sift(u8[None], max_keypoints=128, device="cpu")
    assert len(kp_u[0]) == len(kp_f[0])
    np.testing.assert_allclose(kp_u[0], kp_f[0], atol=1e-3)
    assert (np.abs(dc_u[0].astype(int) - dc_f[0].astype(int)) <= 1).mean() > 0.999


def test_sift_descriptors_match_under_translation():
    """The same content shifted 8 px vertically: the matches follow the
    shift (the matcher is the port's, on the same descriptors)."""
    import scipy.ndimage as ndi

    from vit_colmap_tpu_torch.kernels.match import match_pairs

    rng = np.random.default_rng(0)
    big = ndi.gaussian_filter(rng.random((200, 200)).astype(np.float32), 2.0)
    big = (big - big.min()) / (big.max() - big.min())
    img1, img2 = big[20:148, 20:148], big[28:156, 20:148]
    (k1, k2), (d1, d2) = tsift.extract_sift(np.stack([img1, img2]), max_keypoints=256,
                                            num_octaves=3, contrast_thresh=0.005,
                                            device="cpu")
    assert len(k1) > 20 and len(k2) > 20
    n = max(len(d1), len(d2))

    def pad(d, k):
        dp = torch.zeros(1, n, 128)
        dp[0, :len(d)] = torch.from_numpy(d.astype(np.float32))
        dp = dp / torch.clamp(dp.norm(dim=-1, keepdim=True), min=1e-8)
        v = torch.zeros(1, n, dtype=torch.bool)
        v[0, :len(d)] = True
        kp = np.zeros((n, 2), np.float32)
        kp[:len(k)] = k[:, :2]
        return dp, v, kp

    (d1p, v1, k1p), (d2p, v2, k2p) = pad(d1, k1), pad(d2, k2)
    idx = match_pairs(d1p, d2p, v1, v2)[0].numpy()
    rows = np.nonzero(idx >= 0)[0]
    assert len(rows) >= 10, len(rows)
    dx = k2p[idx[rows], 0] - k1p[rows, 0]
    dy = k2p[idx[rows], 1] - k1p[rows, 1]
    assert ((np.abs(dx) < 3) & (np.abs(dy + 8) < 3)).mean() > 0.6


def test_multi_orientation_emits_secondary_peaks():
    import scipy.ndimage as ndi

    rng = np.random.default_rng(3)
    img = ndi.gaussian_filter(rng.random((128, 128)).astype(np.float32), 2.5)
    img = (img - img.min()) / (img.max() - img.min())
    k1, _ = tsift.extract_sift(img[None], max_keypoints=512, num_orientations=1,
                               device="cpu")
    k2, _ = tsift.extract_sift(img[None], max_keypoints=512, num_orientations=2,
                               device="cpu")
    assert len(k2[0]) > len(k1[0])
    xy = np.round(k2[0][:, :3], 4)
    _, counts = np.unique(xy, axis=0, return_counts=True)
    assert (counts == 2).sum() > 0
