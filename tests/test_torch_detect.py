"""Saliency, keypoint detection and descriptor ops of the PyTorch port
against the JAX package, on shared feature maps made with numpy.

Bounds: identical keypoints and validity, scores within 1e-5, uint8
descriptors within +-1.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_colmap_tpu.ops import detect as jdetect
from vit_colmap_tpu.ops import interpolate as jinterp
from vit_colmap_tpu.ops import scoring as jscoring
from vit_colmap_tpu_torch.ops import detect, interpolate, scoring


def _fmap(seed=0, shape=(2, 17, 23, 64)):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("sigma", [1.0, 1.6])
def test_gaussian_blur(sigma):
    x = _fmap()[..., 0]
    ref = np.asarray(jscoring.gaussian_blur(jnp.asarray(x), sigma))
    out = scoring.gaussian_blur(torch.from_numpy(x), sigma).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)


@pytest.mark.parametrize("method", ["harris", "dog", "combined"])
def test_saliency(method):
    f = _fmap(1)
    ref = np.asarray(jscoring.compute_saliency(jnp.asarray(f), method))
    out = scoring.compute_saliency(torch.from_numpy(f), method).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)


@pytest.mark.parametrize("nms_mode", ["soft", "hard"])
@pytest.mark.parametrize("k_total", [64, 10_000])
def test_detect_keypoints(nms_mode, k_total):
    s = np.array(jscoring.compute_saliency(jnp.asarray(_fmap(2)), "combined"))
    ref = jdetect.detect_keypoints(jnp.asarray(s), k_total=k_total, nms_mode=nms_mode)
    out = detect.detect_keypoints(torch.from_numpy(s), k_total=k_total,
                                  nms_mode=nms_mode)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_allclose(out[1].numpy(), np.asarray(ref[1]), atol=1e-5)
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))


def test_topk_ties_take_lower_index_first():
    """lax.top_k's tie rule: equal scores keep index order."""
    s = np.zeros((1, 8, 8), np.float32)
    s[0, ::2, ::2] = 1.0  # 16 equal peaks
    s[0, 1, 1] = 0.5
    ref = jdetect.select_topk_binned(jnp.asarray(s), k_total=20)
    out = detect.select_topk_binned(torch.from_numpy(s), k_total=20)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_quadratic_refine():
    s = np.array(jscoring.compute_saliency(jnp.asarray(_fmap(3)), "combined"))
    xy = np.array(jdetect.detect_keypoints(jnp.asarray(s), k_total=100)[0])
    ref = np.asarray(jdetect.quadratic_refine(jnp.asarray(s), jnp.asarray(xy)))
    out = detect.quadratic_refine(torch.from_numpy(s), torch.from_numpy(xy)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_bilinear_sample():
    f = _fmap(4)
    rng = np.random.default_rng(4)
    xy = np.stack([rng.uniform(-2, 25, (2, 50)), rng.uniform(-2, 19, (2, 50))],
                  axis=-1).astype(np.float32)
    ref = np.asarray(jinterp.bilinear_sample_batched(jnp.asarray(f), jnp.asarray(xy)))
    out = interpolate.bilinear_sample(torch.from_numpy(f), torch.from_numpy(xy))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


def test_fit_pca_and_descriptor_chain():
    rng = np.random.default_rng(5)
    # Well-separated variances so eigenvectors are unambiguous.
    scales = np.linspace(3.0, 0.1, 32).astype(np.float32)
    x = (rng.standard_normal((500, 32)) * scales).astype(np.float32)
    jc, jm = jinterp.fit_pca(jnp.asarray(x), 8)
    tc, tm = interpolate.fit_pca(torch.from_numpy(x), 8)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-4)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-5)

    feats = x[:64]
    ref = jinterp.quantize_descriptors_signed(jinterp.l2_normalize(
        jinterp.apply_pca(jnp.asarray(feats), jc, jm)))
    out = interpolate.quantize_descriptors_signed(interpolate.l2_normalize(
        interpolate.apply_pca(torch.from_numpy(feats), tc, tm)))
    diff = np.abs(out.numpy().astype(int) - np.asarray(ref).astype(int))
    assert diff.max() <= 1


def test_quantize_truncates():
    d = np.array([-1.0, -0.5, 0.0, 0.004, 0.5, 1.0], np.float32)
    ref = np.asarray(jinterp.quantize_descriptors_signed(jnp.asarray(d)))
    out = interpolate.quantize_descriptors_signed(torch.from_numpy(d)).numpy()
    np.testing.assert_array_equal(out, ref)


def test_pca_npz_round_trip(tmp_path):
    """Files written by either package load in the other."""
    rng = np.random.default_rng(6)
    comps = rng.standard_normal((16, 4)).astype(np.float32)
    mean = rng.standard_normal(16).astype(np.float32)
    jinterp.save_pca(tmp_path / "j.npz", jnp.asarray(comps), jnp.asarray(mean))
    tc, tm = interpolate.load_pca(tmp_path / "j.npz")
    np.testing.assert_array_equal(tc.numpy(), comps)
    interpolate.save_pca(tmp_path / "t.npz", tc, tm)
    jc, jm = jinterp.load_pca(tmp_path / "t.npz")
    np.testing.assert_array_equal(np.asarray(jc), comps)
    np.testing.assert_array_equal(np.asarray(jm), mean)
