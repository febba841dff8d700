"""SIFT (DoG keypoints + gradient-histogram descriptors) in PyTorch.

Counterpart of ``vit_colmap_tpu/ops/sift.py``, stage for stage:

* Gaussian scale space and differences of Gaussians per octave, from the
  separable blur of ``ops/scoring.py``,
* extrema of the 3x3x3 neighbourhood (``max_pool3d``) with the contrast and
  Hessian edge-ratio tests, the edge test's differences wrapping around as
  ``jnp.roll`` does,
* one quadratic sub-pixel / sub-scale step with the refined-contrast test,
* a fixed number of extrema per octave, ranked by |DoG|,
* orientation from a Gaussian-weighted 36-bin histogram on the keypoint's
  own Gaussian level (6x circular smoothing, quadratic peak interpolation),
  one keypoint copy per peak at 0.8 of the maximum or more,
* the 4x4x8 descriptor with trilinear binning, L2 normalization, clipping at
  0.2, renormalization and x512 uint8 (truncated, as the reference casts).

Two rules hold the reference's results on every device:

* **Ties.** ``lax.top_k`` puts the lower index first among equal values;
  :func:`top_k_first` does the same with ``torch.topk`` on keys made unique
  by the index (flat-coloured images do give equal |DoG| values).
* **Precision.** The reference runs SIFT at f32 matmul precision (bf16
  noise near the 0.0133 contrast threshold cut its matching accuracy); here
  every convolution and product runs without TF32
  (``device.exact_f32_convolutions``, ``device.exact_f32_matmuls``), the
  one-hot histogram contractions included.

The reference fuses the whole multi-octave program into one XLA program;
the port runs it eagerly (no kernel of its own: the reference reaches no
``pl.pallas_call``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from vit_colmap_tpu_torch.device import (
    exact_f32_convolutions,
    exact_f32_matmuls,
    resolve_device,
)
from vit_colmap_tpu_torch.ops.interpolate import bilinear_sample
from vit_colmap_tpu_torch.ops.scoring import gaussian_blur

SIGMA0 = 1.6
ORI_SIGMA_FACTOR = 1.5  # orientation window sigma = 1.5 * keypoint sigma
ORI_WINDOW_FACTOR = 3.0  # sample radius = 3 * window sigma
DESC_BIN_SIGMA = 3.0  # descriptor spatial bin size = 3 * keypoint sigma
OCTAVE_STEP = 2  # each octave halves the resolution: pixel factor per octave


def top_k_first(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of f32 values along the last axis, largest first and the lower
    index first among equal values (``lax.top_k``'s order).

    Each value's bits become an integer in the values' order, and the index
    fills the low 32 bits, so every key is unique and ``torch.topk`` has no
    tie to break."""
    n = x.shape[-1]
    bits = x.contiguous().view(torch.int32)
    order = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    idx = torch.arange(n, device=x.device, dtype=torch.int64)
    keys = (order << 32) | (n - 1 - idx)
    top = torch.topk(keys, k, dim=-1).indices
    return torch.gather(x, -1, top), top


def _blur(x: torch.Tensor, sigma: float) -> torch.Tensor:
    return gaussian_blur(x, float(sigma)) if sigma > 0 else x


def build_octave(gray: torch.Tensor, num_scales: int = 3, sigma0: float = SIGMA0,
                 input_sigma: float = 0.5):
    """One octave of scale space: (B, H, W) -> gauss (B, S+3, H, W), dog
    (B, S+2, H, W).  ``input_sigma`` is the blur the input already carries;
    the first level adds only the increment to reach ``sigma0``."""
    k = 2.0 ** (1.0 / num_scales)
    sigmas = [sigma0 * (k**i) for i in range(num_scales + 3)]
    inc0 = float(np.sqrt(max(sigmas[0] ** 2 - input_sigma**2, 0.0)))
    levels = [_blur(gray, inc0)]
    for i in range(1, num_scales + 3):
        inc = float(np.sqrt(max(sigmas[i] ** 2 - sigmas[i - 1] ** 2, 1e-6)))
        levels.append(_blur(levels[-1], inc))
    gauss = torch.stack(levels, dim=1)
    return gauss, gauss[:, 1:] - gauss[:, :-1]


def find_extrema(dog: torch.Tensor, k_per_octave: int = 512,
                 contrast_thresh: float = 0.02, edge_thresh: float = 10.0):
    """3D local extrema of |DoG| with the contrast and edge tests.

    Returns (xy (B, K, 2) in octave pixels, scale_idx (B, K), score (B, K),
    valid (B, K))."""
    B, S, H, W = dog.shape

    def window_max(x):  # 3x3x3 maximum, -inf outside
        return F.max_pool3d(x[:, None], 3, stride=1, padding=1)[:, 0]

    is_max = dog >= window_max(dog)
    is_min = -dog >= window_max(-dog)
    # Relaxed pre-test at half the threshold; the full test runs on the
    # refined value in refine_extrema.
    extremum = (is_max | is_min) & (torch.abs(dog) > 0.5 * contrast_thresh)

    d = dog
    dxx = torch.roll(d, -1, 3) + torch.roll(d, 1, 3) - 2 * d
    dyy = torch.roll(d, -1, 2) + torch.roll(d, 1, 2) - 2 * d
    dxy = (
        torch.roll(torch.roll(d, -1, 2), -1, 3)
        - torch.roll(torch.roll(d, -1, 2), 1, 3)
        - torch.roll(torch.roll(d, 1, 2), -1, 3)
        + torch.roll(torch.roll(d, 1, 2), 1, 3)
    ) / 4.0
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    r = edge_thresh
    edge_ok = (det > 0) & (tr * tr * r < (r + 1.0) ** 2 * det)

    keep = extremum & edge_ok
    interior = torch.zeros((1, S, H, W), dtype=torch.bool, device=dog.device)
    border = 8
    if H > 2 * border and W > 2 * border:  # interior scales, 8 px from the edge
        interior[:, 1:S - 1, border:-border, border:-border] = True
    keep = keep & interior

    score = torch.where(keep, torch.abs(dog), 0.0).reshape(B, -1)
    k = min(k_per_octave, score.shape[1])
    top, idx = top_k_first(score, k)
    s_idx = idx // (H * W)
    rem = idx % (H * W)
    ys = (rem // W).to(torch.float32)
    xs = (rem % W).to(torch.float32)
    return torch.stack([xs, ys], dim=-1), s_idx, top, top > 0


def refine_extrema(dog: torch.Tensor, xy: torch.Tensor, s_idx: torch.Tensor,
                   valid: torch.Tensor, contrast_thresh: float = 0.02):
    """One quadratic sub-pixel / sub-scale step (Lowe section 4) on the
    3x3x3 neighbourhood, clamped to +-0.6 per axis, solved by Cramer's rule,
    with the interpolated contrast re-tested.  Returns (xy_refined,
    s_refined (float), valid_refined)."""
    B, S, H, W = dog.shape
    K = xy.shape[1]
    xi = torch.clamp(xy[..., 0].to(torch.int64), 1, W - 2)
    yi = torch.clamp(xy[..., 1].to(torch.int64), 1, H - 2)
    si = torch.clamp(s_idx, 1, S - 2)
    off = torch.arange(-1, 2, device=dog.device)
    flat = (
        (si[..., None, None, None] + off[:, None, None]) * (H * W)
        + (yi[..., None, None, None] + off[None, :, None]) * W
        + (xi[..., None, None, None] + off[None, None, :])
    )  # (B, K, 3, 3, 3), axes (s, y, x)
    nb = torch.gather(dog.reshape(B, -1), 1, flat.reshape(B, -1)).reshape(B, K, 3, 3, 3)

    d = nb[..., 1, 1, 1]
    gs = (nb[..., 2, 1, 1] - nb[..., 0, 1, 1]) / 2
    gy = (nb[..., 1, 2, 1] - nb[..., 1, 0, 1]) / 2
    gx = (nb[..., 1, 1, 2] - nb[..., 1, 1, 0]) / 2
    hss = nb[..., 2, 1, 1] + nb[..., 0, 1, 1] - 2 * d
    hyy = nb[..., 1, 2, 1] + nb[..., 1, 0, 1] - 2 * d
    hxx = nb[..., 1, 1, 2] + nb[..., 1, 1, 0] - 2 * d
    hsy = (nb[..., 2, 2, 1] - nb[..., 2, 0, 1] - nb[..., 0, 2, 1] + nb[..., 0, 0, 1]) / 4
    hsx = (nb[..., 2, 1, 2] - nb[..., 2, 1, 0] - nb[..., 0, 1, 2] + nb[..., 0, 1, 0]) / 4
    hyx = (nb[..., 1, 2, 2] - nb[..., 1, 2, 0] - nb[..., 1, 0, 2] + nb[..., 1, 0, 0]) / 4

    det = (
        hss * (hyy * hxx - hyx * hyx)
        - hsy * (hsy * hxx - hyx * hsx)
        + hsx * (hsy * hyx - hyy * hsx)
    )
    safe = torch.abs(det) > 1e-12
    det = torch.where(safe, det, 1.0)
    b1, b2, b3 = -gs, -gy, -gx
    ds = (
        b1 * (hyy * hxx - hyx * hyx)
        - hsy * (b2 * hxx - hyx * b3)
        + hsx * (b2 * hyx - hyy * b3)
    ) / det
    dy = (
        hss * (b2 * hxx - b3 * hyx)
        - b1 * (hsy * hxx - hyx * hsx)
        + hsx * (hsy * b3 - b2 * hsx)
    ) / det
    dx = (
        hss * (hyy * b3 - b2 * hyx)
        - hsy * (hsy * b3 - b2 * hsx)
        + b1 * (hsy * hyx - hyy * hsx)
    ) / det
    lim = 0.6
    ds = torch.clamp(torch.where(safe, ds, 0.0), -lim, lim)
    dy = torch.clamp(torch.where(safe, dy, 0.0), -lim, lim)
    dx = torch.clamp(torch.where(safe, dx, 0.0), -lim, lim)

    d_hat = d + 0.5 * (gs * ds + gy * dy + gx * dx)
    valid = valid & (torch.abs(d_hat) >= contrast_thresh)
    xy_ref = torch.stack([xi.to(torch.float32) + dx, yi.to(torch.float32) + dy], dim=-1)
    return xy_ref, si.to(torch.float32) + ds, valid


def _gradient_fm(levels: torch.Tensor) -> torch.Tensor:
    """(B, L, H, W) Gaussian levels -> (B, L, H, W, 2) [magnitude, angle]."""
    xp = F.pad(levels, (1, 1, 1, 1), mode="replicate")
    gx = (xp[:, :, 1:-1, 2:] - xp[:, :, 1:-1, :-2]) / 2.0
    gy = (xp[:, :, 2:, 1:-1] - xp[:, :, :-2, 1:-1]) / 2.0
    return torch.stack([torch.sqrt(gx * gx + gy * gy), torch.atan2(gy, gx)], dim=-1)


def _sample_level_stacked(fm_stacked: torch.Tensor, pts: torch.Tensor,
                          level: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Bilinear (mag, ang) at pts (B, K, P, 2) from each keypoint's own level
    of the level-stacked map (B, L*H, W, 2); coordinates clamp to the level's
    band before its offset is added, so no sample crosses levels."""
    B, K, P, _ = pts.shape
    x = torch.clamp(pts[..., 0], 0.0, W - 1.0)
    y = torch.clamp(pts[..., 1], 0.0, H - 1.0)
    y = y + level[..., None].to(torch.float32) * H
    flat = torch.stack([x, y], dim=-1).reshape(B, K * P, 2)
    return bilinear_sample(fm_stacked, flat).reshape(B, K, P, 2)


def _quad_interp_bins(hist: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Quadratic interpolation of circular-histogram bins ``p`` -> angles
    in (-pi, pi]."""
    nb = hist.shape[-1]
    c = torch.gather(hist, -1, p)
    left = torch.gather(hist, -1, (p - 1) % nb)
    right = torch.gather(hist, -1, (p + 1) % nb)
    denom = left - 2 * c + right
    off = torch.where(torch.abs(denom) > 1e-12, 0.5 * (left - right) / denom, 0.0)
    off = torch.clamp(off, -0.5, 0.5)
    return (p.to(torch.float32) + 0.5 + off) / nb * 2 * np.pi - np.pi


def _interp_peak(hist: torch.Tensor) -> torch.Tensor:
    """Angle of the circular histogram's interpolated peak (the first
    maximal bin, as ``jnp.argmax``)."""
    p = torch.argmax(hist, dim=-1)
    return _quad_interp_bins(hist, p[..., None])[..., 0]


def _peaks_from_hist(hist: torch.Tensor, max_peaks: int, peak_ratio: float):
    """The ``max_peaks`` highest local maxima at ``peak_ratio`` of the
    global maximum or more (COLMAP / VLFeat); slot 0 is the global maximum.
    Returns (angles (..., max_peaks), valid (..., max_peaks))."""
    left = torch.roll(hist, 1, -1)
    right = torch.roll(hist, -1, -1)
    gmax = torch.amax(hist, -1, keepdim=True)
    qualified = ((hist > left) & (hist >= right) & (hist >= peak_ratio * gmax)) | (
        hist >= gmax)
    vals = torch.where(qualified & (hist > 0), hist, -torch.inf)
    top_v, top_i = top_k_first(vals, max_peaks)
    return _quad_interp_bins(hist, top_i), torch.isfinite(top_v)


def _orientation_hist(m, a, w, num_bins: int):
    """(B, K, P) magnitude / angle / weight -> the 36-bin circular
    histogram after 6 smoothing passes."""
    bins = torch.floor((a + np.pi) / (2 * np.pi) * num_bins).to(torch.int64)
    bins = torch.clamp(bins, 0, num_bins - 1)
    onehot = F.one_hot(bins, num_bins).to(m.dtype)  # (B, K, P, nb)
    hist = torch.einsum("bkp,bkpn->bkn", m * w, onehot)
    for _ in range(6):
        hist = (torch.roll(hist, 1, -1) + hist + torch.roll(hist, -1, -1)) / 3.0
    return hist


def _unit_grid(radius: int, device) -> torch.Tensor:
    """(P, 2) integer offsets (x, y) of the (2r+1)^2 window, row-major."""
    offs = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    oy, ox = torch.meshgrid(offs, offs, indexing="ij")
    return torch.stack([ox.reshape(-1), oy.reshape(-1)], dim=-1)


def dominant_orientation(gauss: torch.Tensor, xy: torch.Tensor, num_bins: int = 36,
                         radius: int = 8) -> torch.Tensor:
    """Single-level dominant orientation: a fixed pixel window, Gaussian
    weight sigma = radius / 2."""
    B = gauss.shape[0]
    fm = _gradient_fm(gauss[:, None])[:, 0]  # (B, H, W, 2)
    grid = _unit_grid(radius, gauss.device)
    pts = xy[:, :, None, :] + grid[None, None]
    K, P = xy.shape[1], grid.shape[0]
    samp = bilinear_sample(fm, pts.reshape(B, K * P, 2)).reshape(B, K, P, 2)
    w = torch.exp(-(grid[:, 0] ** 2 + grid[:, 1] ** 2) / (2.0 * (radius / 2.0) ** 2))
    hist = _orientation_hist(samp[..., 0], samp[..., 1], w[None, None], num_bins)
    return _interp_peak(hist)


def _multilevel_hist(fm_stacked, xy, level, sigma_kp, H, W, num_bins, grid_radius):
    """The orientation histogram on each keypoint's own level: window radius
    3 x (1.5 sigma), Gaussian weight sigma 1.5 sigma, on a fixed (2r+1)^2
    grid scaled per keypoint."""
    grid = _unit_grid(grid_radius, xy.device)
    win_sigma = ORI_SIGMA_FACTOR * sigma_kp  # (B, K)
    step = (ORI_WINDOW_FACTOR * win_sigma / grid_radius)[..., None, None]
    pts = xy[:, :, None, :] + grid[None, None] * step
    samp = _sample_level_stacked(fm_stacked, pts, level, H, W)
    r2 = (grid[:, 0] ** 2 + grid[:, 1] ** 2)[None, None] * step[..., 0] ** 2
    w = torch.exp(-r2 / (2.0 * win_sigma[..., None] ** 2))
    return _orientation_hist(samp[..., 0], samp[..., 1], w, num_bins)


def dominant_orientation_multilevel(fm_stacked: torch.Tensor, xy: torch.Tensor,
                                    level: torch.Tensor, sigma_kp: torch.Tensor,
                                    H: int, W: int, num_bins: int = 36,
                                    grid_radius: int = 8) -> torch.Tensor:
    """Scale-adaptive orientation on the keypoint's own Gaussian level."""
    return _interp_peak(_multilevel_hist(fm_stacked, xy, level, sigma_kp, H, W,
                                         num_bins, grid_radius))


def orientation_peaks_multilevel(fm_stacked: torch.Tensor, xy: torch.Tensor,
                                 level: torch.Tensor, sigma_kp: torch.Tensor,
                                 H: int, W: int, num_bins: int = 36,
                                 grid_radius: int = 8, max_peaks: int = 2,
                                 peak_ratio: float = 0.8):
    """Multi-orientation variant: (angles (B, K, max_peaks), valid (B, K,
    max_peaks)), one keypoint copy per qualifying peak."""
    hist = _multilevel_hist(fm_stacked, xy, level, sigma_kp, H, W, num_bins,
                            grid_radius)
    return _peaks_from_hist(hist, max_peaks, peak_ratio)


def _spatial_bin_matrices(rel_np: np.ndarray) -> list[np.ndarray]:
    """The four (P, 16) bilinear spatial-bin weight matrices of a fixed
    sample grid in [-0.5, 0.5)."""
    P = rel_np.shape[0]
    c = (rel_np + 0.5) * 4.0 - 0.5  # bin coordinates in [-0.5, 3.5]
    c0 = np.floor(c).astype(np.int32)
    fr = (c - c0).astype(np.float32)
    mats = []
    for sy_ in (0, 1):
        for sx_ in (0, 1):
            ix = c0[:, 0] + sx_
            iy = c0[:, 1] + sy_
            wxy = (fr[:, 0] if sx_ else 1 - fr[:, 0]) * (fr[:, 1] if sy_ else 1 - fr[:, 1])
            ok = (ix >= 0) & (ix <= 3) & (iy >= 0) & (iy <= 3)
            onehot = np.zeros((P, 16), np.float32)
            onehot[np.arange(P), np.clip(iy, 0, 3) * 4 + np.clip(ix, 0, 3)] = wxy * ok
            mats.append(onehot)
    return mats


def _descriptor_core(m: torch.Tensor, a_rel: torch.Tensor, rel_np: np.ndarray):
    """Trilinear 4x4x8 binning of (B, K, P) weighted magnitudes at angles in
    the keypoint's frame -> (B, K, 128) uint8.  The spatial weights are
    static (the sample grid is fixed); only the orientation bins depend on
    the data."""
    B, K, _ = m.shape
    a = torch.remainder(a_rel, 2 * np.pi)  # [0, 2pi)
    ob = a / (2 * np.pi) * 8.0 - 0.5
    o0 = torch.floor(ob)
    frac = ob - o0
    o0 = torch.remainder(o0.to(torch.int64), 8)

    desc = torch.zeros((B, K, 16, 8), dtype=m.dtype, device=m.device)
    sp_mats = [torch.from_numpy(s).to(m.device) for s in _spatial_bin_matrices(rel_np)]
    for so in (0, 1):
        io = torch.remainder(o0 + so, 8)
        wo = frac if so else 1 - frac
        ob_onehot = F.one_hot(io, 8).to(m.dtype) * wo[..., None]
        for sp_onehot in sp_mats:
            desc = desc + torch.einsum("bkp,pn,bkpo->bkno", m, sp_onehot, ob_onehot)
    desc = desc.reshape(B, K, 128)
    norm = torch.clamp(torch.linalg.vector_norm(desc, dim=-1, keepdim=True), min=1e-8)
    desc = torch.clamp(desc / norm, 0.0, 0.2)
    norm = torch.clamp(torch.linalg.vector_norm(desc, dim=-1, keepdim=True), min=1e-8)
    desc = desc / norm
    # Truncated to uint8 (the values are non-negative), as the reference casts.
    return torch.clamp(desc * 512.0, 0.0, 255.0).to(torch.uint8)


def _window_grid(window: int) -> np.ndarray:
    """(window^2, 2) sample positions (x, y) in [-0.5, 0.5), row-major."""
    u = (np.arange(window, dtype=np.float32) + 0.5) / window - 0.5
    uy, ux = np.meshgrid(u, u, indexing="ij")
    return np.stack([ux.ravel(), uy.ravel()], axis=-1)


def _descriptor_samples(xy, orientation, scale_px, rel_np):
    """The rotated, scaled sample grid (B, K, P, 2) and its Gaussian window
    weights (P,) (sigma 0.5 of the window)."""
    rel = torch.from_numpy(rel_np).to(xy.device)
    cos = torch.cos(orientation)[..., None]
    sin = torch.sin(orientation)[..., None]
    rx = rel[None, None, :, 0] * cos - rel[None, None, :, 1] * sin
    ry = rel[None, None, :, 0] * sin + rel[None, None, :, 1] * cos
    size = scale_px[..., None]
    pts = torch.stack([xy[..., 0:1] + rx * size, xy[..., 1:2] + ry * size], dim=-1)
    gw = torch.exp(-(rel[:, 0] ** 2 + rel[:, 1] ** 2) * 2.0)
    return pts, gw


def sift_descriptors(gauss: torch.Tensor, xy: torch.Tensor, orientation: torch.Tensor,
                     scale_px: torch.Tensor, window: int = 16) -> torch.Tensor:
    """Single-level descriptor (B, K, 128) uint8 on one gradient level
    (B, H, W)."""
    B = gauss.shape[0]
    fm = _gradient_fm(gauss[:, None])[:, 0]
    rel_np = _window_grid(window)
    pts, gw = _descriptor_samples(xy, orientation, scale_px, rel_np)
    K, P = xy.shape[1], rel_np.shape[0]
    samp = bilinear_sample(fm, pts.reshape(B, K * P, 2)).reshape(B, K, P, 2)
    m = samp[..., 0] * gw[None, None]
    a_rel = samp[..., 1] - orientation[..., None]
    return _descriptor_core(m, a_rel, rel_np)


def sift_descriptors_multilevel(fm_stacked: torch.Tensor, xy: torch.Tensor,
                                level: torch.Tensor, orientation: torch.Tensor,
                                scale_px: torch.Tensor, H: int, W: int,
                                window: int = 16) -> torch.Tensor:
    """Descriptor sampled from each keypoint's own Gaussian level."""
    rel_np = _window_grid(window)
    pts, gw = _descriptor_samples(xy, orientation, scale_px, rel_np)
    samp = _sample_level_stacked(fm_stacked, pts, level, H, W)
    m = samp[..., 0] * gw[None, None]
    a_rel = samp[..., 1] - orientation[..., None]
    return _descriptor_core(m, a_rel, rel_np)


def upsample2x(img: torch.Tensor) -> torch.Tensor:
    """(B, H, W) -> (B, 2H, 2W) linear interpolation on half-pixel centres,
    which is ``jax.image.resize(..., "linear")`` at 2x (its edge weights,
    renormalized inside the image, equal the clamped edge sample)."""
    return F.interpolate(img[:, None], scale_factor=2, mode="bilinear",
                         align_corners=False)[:, 0]


@torch.no_grad()
def _sift_program(gray: torch.Tensor, *, max_keypoints: int, num_octaves: int,
                  num_scales: int, contrast_thresh: float, first_octave: int,
                  num_orientations: int, per_oct: int):
    """The whole multi-octave SIFT, the reference's ``_sift_program``, in
    exact f32: (B, H, W) float32 in [0, 1] or uint8 -> (kpts (B, K, 4) [x,
    y, scale, orientation] in image pixels, desc (B, K, 128) uint8, valid
    (B, K)), the final top ``max_keypoints`` taken over all octaves on the
    device."""
    with exact_f32_matmuls(), exact_f32_convolutions():
        return _sift_body(gray, max_keypoints=max_keypoints, num_octaves=num_octaves,
                          num_scales=num_scales, contrast_thresh=contrast_thresh,
                          first_octave=first_octave, num_orientations=num_orientations,
                          per_oct=per_oct)


def _sift_body(gray, *, max_keypoints, num_octaves, num_scales, contrast_thresh,
               first_octave, num_orientations, per_oct):
    B = gray.shape[0]
    if gray.dtype == torch.uint8:
        gray = gray.to(torch.float32) / 255.0
    img = gray
    base_factor = 1.0
    input_sigma = 0.5  # assumed camera blur of the raw image (Lowe)
    if first_octave < 0:
        img = upsample2x(img)
        base_factor = 0.5
        input_sigma = 1.0  # the doubled image carries doubled blur
    k = 2.0 ** (1.0 / num_scales)
    outs = []  # per octave (xy_img, orient, scale_img, valid, desc, score)
    for o in range(num_octaves):
        if min(img.shape[1], img.shape[2]) < 32:
            break
        gauss, dog = build_octave(img, num_scales=num_scales, input_sigma=input_sigma)
        input_sigma = SIGMA0  # the downsampled next input already carries sigma0
        Ho, Wo = gauss.shape[2], gauss.shape[3]
        xy, s_idx, score, valid = find_extrema(dog, k_per_octave=per_oct,
                                               contrast_thresh=contrast_thresh)
        xy, s_ref, valid = refine_extrema(dog, xy, s_idx, valid,
                                          contrast_thresh=contrast_thresh)
        # Gradients come from each keypoint's own Gaussian level: DoG index s
        # (gauss s+1 minus gauss s) peaks at sigma(gauss level s).
        level = torch.clamp(torch.round(s_ref).to(torch.int64), 0, num_scales + 2)
        sigma_kp = SIGMA0 * torch.pow(k, s_ref)
        L = num_scales + 3
        fm = _gradient_fm(gauss).reshape(B, L * Ho, Wo, 2)
        if num_orientations > 1:
            # One keypoint copy per orientation peak (K * Pk slots, masked by
            # the peaks' validity).
            orient_pk, peak_ok = orientation_peaks_multilevel(
                fm, xy, level, sigma_kp, Ho, Wo, max_peaks=num_orientations)
            Pk = num_orientations
            K = xy.shape[1]
            xy = torch.repeat_interleave(xy, Pk, dim=1)
            level = torch.repeat_interleave(level, Pk, dim=1)
            sigma_kp = torch.repeat_interleave(sigma_kp, Pk, dim=1)
            orient = orient_pk.reshape(B, K * Pk)
            valid = (valid[:, :, None] & peak_ok).reshape(B, K * Pk)
            # Secondary copies sort just after their primary on score ties.
            score = (score[:, :, None] - torch.arange(Pk, dtype=score.dtype,
                                                      device=score.device) * 1e-6
                     ).reshape(B, K * Pk)
        else:
            orient = dominant_orientation_multilevel(fm, xy, level, sigma_kp, Ho, Wo)
        # 4 spatial bins x 3 sigma a bin: a window 12 sigma wide.
        win_px = DESC_BIN_SIGMA * 4.0 * sigma_kp
        desc = sift_descriptors_multilevel(fm, xy, level, orient, win_px, Ho, Wo)
        factor = base_factor * OCTAVE_STEP**o
        outs.append((xy * factor, orient, sigma_kp * factor, valid, desc, score))
        img = gauss[:, num_scales][:, ::2, ::2]  # the next octave's input

    xy, orient, scale, valid, desc, score = (torch.cat(parts, dim=1)
                                             for parts in zip(*outs))
    # Top max_keypoints over all octaves; invalid slots sink to -inf, ties
    # keep the lower index (octave order).
    ranked = torch.where(valid, score, -torch.inf)
    top, idx = top_k_first(ranked, min(max_keypoints, ranked.shape[1]))
    kp = torch.stack([torch.gather(xy[..., 0], 1, idx), torch.gather(xy[..., 1], 1, idx),
                      torch.gather(scale, 1, idx), torch.gather(orient, 1, idx)], dim=-1)
    desc_sel = torch.gather(desc, 1, idx[..., None].expand(-1, -1, desc.shape[-1]))
    return kp.to(torch.float32), desc_sel, torch.isfinite(top)


def extract_sift(gray, max_keypoints: int = 4096, num_octaves: int = 4,
                 num_scales: int = 3, contrast_thresh: float = 0.0133,
                 first_octave: int = -1, num_orientations: int = 2,
                 device: Optional[object] = None):
    """Multi-octave SIFT of a (B, H, W) batch (float32 in [0, 1] or uint8,
    numpy or a tensor); returns per image (kpts (N, 4) [x, y, scale,
    orientation] in image pixels, desc (N, 128) uint8) as two numpy lists.
    Runs on the card unless ``device`` says otherwise.

    ``first_octave=-1`` starts from the image upsampled 2x (COLMAP / cv2),
    0 at native resolution; ``contrast_thresh`` is cv2's effective
    per-layer threshold (0.04 / nlayers) on [0, 1] images;
    ``num_orientations`` copies a keypoint for every orientation peak at 0.8
    of the maximum or more (COLMAP's default 2), 1 keeps one."""
    dev = resolve_device(device)
    gray_t = torch.as_tensor(np.asarray(gray) if not isinstance(gray, torch.Tensor)
                             else gray).to(dev)
    kp, desc, valid = _sift_program(
        gray_t, max_keypoints=max_keypoints, num_octaves=num_octaves,
        num_scales=num_scales, contrast_thresh=contrast_thresh,
        first_octave=first_octave, num_orientations=num_orientations,
        per_oct=max(max_keypoints // num_octaves, 64))
    kp_np, desc_np, valid_np = kp.cpu().numpy(), desc.cpu().numpy(), valid.cpu().numpy()
    kpts_out, desc_out = [], []
    for b in range(kp_np.shape[0]):
        v = valid_np[b]
        kpts_out.append(kp_np[b][v] if v.any() else np.zeros((0, 4), np.float32))
        desc_out.append(desc_np[b][v] if v.any() else np.zeros((0, 128), np.uint8))
    return kpts_out, desc_out
