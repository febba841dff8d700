"""Bilinear sampling and descriptor projection.

Counterpart of ``vit_colmap_tpu/ops/interpolate.py``: border-clamped
bilinear sampling, an order-independent PCA fit (covariance ``eigh`` with
canonical component signs) that can be persisted as ``.npz``, L2
normalization and the signed uint8 descriptor encoding.
"""

from __future__ import annotations

import numpy as np
import torch


def bilinear_sample(fmap: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Sample (B, H, W, C) features at (B, N, 2) continuous (x, y) map
    coordinates, clamped to the border -> (B, N, C).

    The four corners are read by one indexing, whose gradient accumulates
    in sorted order (``index_put_`` with ``accumulate=True``); ``gather``'s
    adds with float atomics on the card, in no fixed order.  One indexing
    for all four keeps the backward to one sort."""
    B, H, W, C = fmap.shape
    N = xy.shape[1]
    x = torch.clamp(xy[..., 0], 0.0, W - 1.0)
    y = torch.clamp(xy[..., 1], 0.0, H - 1.0)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    x1 = torch.clamp_max(x0 + 1, W - 1)
    y1 = torch.clamp_max(y0 + 1, H - 1)
    wx = (x - x0.to(x.dtype))[..., None]
    wy = (y - y0.to(y.dtype))[..., None]
    idx = torch.stack([y0 * W + x0, y0 * W + x1, y1 * W + x0, y1 * W + x1], dim=-1)
    batch = torch.arange(B, device=fmap.device)[:, None]
    g = fmap.reshape(B, H * W, C)[batch, idx.reshape(B, 4 * N)].reshape(B, N, 4, C)
    top = g[:, :, 0] * (1 - wx) + g[:, :, 1] * wx
    bot = g[:, :, 2] * (1 - wx) + g[:, :, 3] * wx
    return top * (1 - wy) + bot * wy


def fit_pca(features: torch.Tensor, out_dim: int = 128):
    """PCA of (N, C) rows -> (components (C, out_dim), mean (C,)).

    Eigenvectors of the covariance, largest first, each signed so that its
    largest-magnitude entry is positive."""
    mean = features.mean(dim=0)
    x = features - mean
    cov = (x.T @ x) / max(x.shape[0] - 1, 1)
    _, eigvecs = torch.linalg.eigh(cov)  # ascending
    comps = eigvecs.flip(1)[:, :out_dim]
    pivot = torch.argmax(torch.abs(comps), dim=0)
    signs = torch.sign(comps[pivot, torch.arange(comps.shape[1], device=comps.device)])
    comps = comps * torch.where(signs == 0, 1.0, signs)[None, :]
    return comps, mean


def save_pca(path, components: torch.Tensor, mean: torch.Tensor) -> None:
    """Persist a PCA projection as ``.npz`` (the JAX package's format)."""
    np.savez(
        str(path),
        components=components.detach().cpu().numpy().astype(np.float32),
        mean=mean.detach().cpu().numpy().astype(np.float32),
    )


def load_pca(path, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    z = np.load(str(path))
    return (
        torch.from_numpy(z["components"]).to(device),
        torch.from_numpy(z["mean"]).to(device),
    )


def apply_pca(features: torch.Tensor, components: torch.Tensor, mean: torch.Tensor):
    return (features - mean) @ components


def l2_normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return x / torch.clamp_min(torch.linalg.norm(x, dim=dim, keepdim=True), 1e-8)


def quantize_descriptors_signed(desc: torch.Tensor) -> torch.Tensor:
    """[-1, 1] descriptors -> uint8 via (d + 1) * 127.5, truncated."""
    return torch.clamp((desc + 1.0) * 127.5, 0.0, 255.0).to(torch.uint8)
