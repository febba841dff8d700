"""Saliency scoring on dense ViT feature maps.

Counterpart of ``vit_colmap_tpu/ops/scoring.py``: Harris corner response on
the structure tensor of channel-mean gradients (k = 0.04, blended
0.7 * corner + 0.3 * edge), difference of Gaussians (sigma 1.0 / 1.6) and
their mean, batched over (B, H, W) maps.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vit_colmap_tpu_torch.device import exact_f32_convolutions


def _gaussian_kernel1d(sigma: float, radius: int, device) -> torch.Tensor:
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def gaussian_blur(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur on (B, H, W) with edge padding."""
    radius = max(1, int(3.0 * sigma + 0.5))
    k = _gaussian_kernel1d(sigma, radius, x.device)
    taps = 2 * radius + 1
    # Along H: pad the rows with their edge values, then a 1-D correlation.
    # f32 throughout, as the reference: no TF32 in cuDNN.
    with exact_f32_convolutions():
        xp = F.pad(x[:, None], (0, 0, radius, radius), mode="replicate")
        xh = F.conv2d(xp, k.reshape(1, 1, taps, 1))
        xp = F.pad(xh, (radius, radius, 0, 0), mode="replicate")
        return F.conv2d(xp, k.reshape(1, 1, 1, taps))[:, 0]


def _gradients(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Central-difference gradients on (B, H, W) with edge replication."""
    xp = F.pad(x[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    gy = (xp[:, 2:, 1:-1] - xp[:, :-2, 1:-1]) / 2.0
    gx = (xp[:, 1:-1, 2:] - xp[:, 1:-1, :-2]) / 2.0
    return gx, gy


def _norm01(v: torch.Tensor) -> torch.Tensor:
    lo = v.amin(dim=(-2, -1), keepdim=True)
    hi = v.amax(dim=(-2, -1), keepdim=True)
    return (v - lo) / torch.clamp_min(hi - lo, 1e-8)


def harris_response(
    fmap_mean: torch.Tensor, k: float = 0.04, corner_weight: float = 0.7
) -> torch.Tensor:
    gx, gy = _gradients(fmap_mean)
    ixx = gaussian_blur(gx * gx, 1.0)
    iyy = gaussian_blur(gy * gy, 1.0)
    ixy = gaussian_blur(gx * gy, 1.0)
    det = ixx * iyy - ixy * ixy
    tr = ixx + iyy
    corner = det - k * tr * tr
    edge = torch.sqrt(gx * gx + gy * gy)
    return corner_weight * _norm01(corner) + (1.0 - corner_weight) * _norm01(edge)


def dog_response(
    fmap_mean: torch.Tensor, sigma1: float = 1.0, sigma2: float = 1.6
) -> torch.Tensor:
    d = gaussian_blur(fmap_mean, sigma1) - gaussian_blur(fmap_mean, sigma2)
    return _norm01(torch.abs(d))


def compute_saliency(fmap: torch.Tensor, method: str = "combined") -> torch.Tensor:
    """fmap: (B, H, W, C) patch features -> (B, H, W) saliency in [0, 1]."""
    mean_map = fmap.mean(dim=-1)
    if method == "harris":
        return harris_response(mean_map)
    if method == "dog":
        return dog_response(mean_map)
    if method == "combined":
        return 0.5 * harris_response(mean_map) + 0.5 * dog_response(mean_map)
    raise ValueError(f"Unknown saliency method: {method}")
