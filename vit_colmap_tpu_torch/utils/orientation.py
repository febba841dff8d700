"""Keypoint orientation from image gradients.

Counterpart of ``vit_colmap_tpu/utils/orientation.py``: luminance, central
differences with edge replication, and the two orientation estimates the
trainer can use -- the gradient direction at each keypoint (the training
ground truth) and a SIFT-style 36-bin histogram (``ops/sift.py``).

The gradient direction is atan2 of a blurred gradient, which rounding
decides wherever the image is flat (atan2(0, 0) is 0, atan2 of two
rounding residues anything).  So its blur is ``ops/scoring.
gaussian_blur``'s (the same taps and edge padding) summed tap by tap with
elementwise operations, not by a convolution: every pixel of a flat region
sums the same values in the same order, and the card and the CPU give the
same bits where a library convolution's algorithm would not.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vit_colmap_tpu_torch.ops.interpolate import bilinear_sample


def rgb_to_gray(images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) in [0, 1] or uint8 -> (B, H, W) float32 luminance."""
    x = images.float()
    return 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]


def compute_image_gradients(gray: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Central differences with edge replication on (B, H, W): (gx, gy)."""
    xp = F.pad(gray[:, None], (1, 1, 1, 1), mode="replicate")[:, 0]
    gx = (xp[:, 1:-1, 2:] - xp[:, 1:-1, :-2]) / 2.0
    gy = (xp[:, 2:, 1:-1] - xp[:, :-2, 1:-1]) / 2.0
    return gx, gy


def blur_by_taps(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """``ops/scoring.gaussian_blur`` of (B, H, W) (along H, then W; edges
    replicated) as a fixed-order sum of shifted copies, with the taps
    computed on the CPU."""
    from vit_colmap_tpu_torch.ops.scoring import _gaussian_kernel1d

    radius = max(1, int(3.0 * sigma + 0.5))
    taps = _gaussian_kernel1d(sigma, radius, "cpu").tolist()
    for dim in (1, 2):
        pad = (0, 0, radius, radius) if dim == 1 else (radius, radius, 0, 0)
        xp = F.pad(x[:, None], pad, mode="replicate")[:, 0]
        n = x.shape[dim]
        acc = xp.narrow(dim, 0, n) * taps[0]
        for i in range(1, len(taps)):
            acc = acc + xp.narrow(dim, i, n) * taps[i]
        x = acc
    return x


def compute_keypoint_orientations_histogram(
    gray: torch.Tensor,  # (B, H, W)
    kpts: torch.Tensor,  # (B, K, 2) pixel coords
    num_bins: int = 36,
    radius: int = 8,
) -> torch.Tensor:
    """SIFT-style Gaussian-weighted orientation histogram -> (B, K) angles
    (:func:`vit_colmap_tpu_torch.ops.sift.dominant_orientation`)."""
    from vit_colmap_tpu_torch.ops.sift import dominant_orientation

    return dominant_orientation(gray, kpts, num_bins=num_bins, radius=radius)


def compute_keypoint_orientations_simple(
    gray: torch.Tensor,  # (B, H, W)
    kpts: torch.Tensor,  # (B, K, 2) pixel coords (x, y)
    smooth_sigma: float = 1.0,
) -> torch.Tensor:
    """Gradient direction at the keypoints, read bilinearly from a gradient
    field blurred with ``smooth_sigma`` (:func:`blur_by_taps`): (B, K)
    angles in [-pi, pi], NaN mapped to 0."""
    gx, gy = compute_image_gradients(gray)
    if smooth_sigma > 0:
        gx = blur_by_taps(gx, smooth_sigma)
        gy = blur_by_taps(gy, smooth_sigma)
    g = bilinear_sample(torch.stack([gx, gy], dim=-1), kpts)  # (B, K, 2)
    return torch.nan_to_num(torch.atan2(g[..., 1], g[..., 0]))
