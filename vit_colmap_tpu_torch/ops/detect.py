"""Keypoint selection on dense score maps.

Counterpart of ``vit_colmap_tpu/ops/detect.py``: max-pool NMS, spatially
binned top-k with a fixed ``k`` and validity mask, soft/hard NMS modes and
separable quadratic sub-cell refinement.

Tie rule: ``lax.top_k`` puts the lower index first among equal values, and
``torch.topk`` promises no order, so selection here is a stable descending
sort.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, lower index first among ties."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def nms_maxpool(scores: torch.Tensor, radius: int = 1) -> torch.Tensor:
    """(B, H, W) -> scores with non-local-maxima zeroed (window 2r+1)."""
    if radius <= 0:
        return scores
    pooled = F.max_pool2d(scores[:, None], 2 * radius + 1, stride=1, padding=radius)
    return torch.where(scores >= pooled[:, 0], scores, 0.0)


def select_topk_binned(
    scores: torch.Tensor, bin_size: int = 2, k_per_bin: int = 4, k_total: int = 1024
):
    """Keep the ``k_per_bin`` best per bin_size x bin_size cell, then the
    ``k_total`` best overall.  Returns xy (B, K, 2) f32 map coords (x, y),
    score (B, K) and valid (B, K) = score > 0."""
    B, H, W = scores.shape
    pad_h = (-H) % bin_size
    pad_w = (-W) % bin_size
    s = F.pad(scores, (0, pad_w, 0, pad_h), value=0.0)
    nh, nw = (H + pad_h) // bin_size, (W + pad_w) // bin_size
    cells = s.reshape(B, nh, bin_size, nw, bin_size).permute(0, 1, 3, 2, 4)
    cells = cells.reshape(B, nh * nw, bin_size * bin_size)
    kpb = min(k_per_bin, bin_size * bin_size)
    cell_top, cell_idx = top_k(cells, kpb)

    bin_ids = torch.arange(nh * nw, device=scores.device)
    by = (bin_ids // nw)[None, :, None]
    bx = (bin_ids % nw)[None, :, None]
    ys = by * bin_size + cell_idx // bin_size
    xs = bx * bin_size + cell_idx % bin_size

    flat_scores = cell_top.reshape(B, -1)
    k_total = min(k_total, flat_scores.shape[1])
    top_scores, top_i = top_k(flat_scores, k_total)
    gx = torch.gather(xs.reshape(B, -1), 1, top_i)
    gy = torch.gather(ys.reshape(B, -1), 1, top_i)
    valid = (top_scores > 0.0) & (gx < W) & (gy < H)
    xy = torch.stack([gx, gy], dim=-1).float()
    return xy, top_scores, valid


def quadratic_refine(scores: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Separable 1-D quadratic fit through each peak's 3-neighbourhood.

    scores: (B, H, W) raw scores; xy: (B, K, 2) integer map coords.
    Returns (B, K, 2) offsets in [-0.5, 0.5] cells."""
    B, H, W = scores.shape
    flat = scores.reshape(B, -1)
    x = xy[..., 0].long()
    y = xy[..., 1].long()

    def at(dy: int, dx: int) -> torch.Tensor:
        yy = torch.clamp(y + dy, 0, H - 1)
        xx = torch.clamp(x + dx, 0, W - 1)
        return torch.gather(flat, 1, yy * W + xx)

    sc = at(0, 0)

    def off(m, c, p):
        denom = m - 2.0 * c + p
        big = torch.abs(denom) > 1e-6
        d = torch.where(big, 0.5 * (m - p) / torch.where(big, denom, 1.0), 0.0)
        return torch.clamp(d, -0.5, 0.5)

    return torch.stack(
        [off(at(0, -1), sc, at(0, 1)), off(at(-1, 0), sc, at(1, 0))], dim=-1
    )


def detect_keypoints(
    scores: torch.Tensor,
    nms_radius: int = 1,
    bin_size: int = 2,
    k_per_bin: int = 4,
    k_total: int = 1024,
    score_threshold: float = 0.0,
    nms_mode: str = "hard",
):
    """NMS + binned top-k.  ``"hard"``: only local maxima survive;
    ``"soft"``: local maxima are lifted by +1 so they rank first, and
    non-maxima fill the remaining budget."""
    peaks = nms_maxpool(scores, nms_radius)
    if nms_mode == "soft":
        s = torch.where(peaks > score_threshold, scores + 1.0, scores)
    elif nms_mode == "hard":
        s = peaks
    else:
        raise ValueError(f"unknown nms_mode {nms_mode!r}")
    s = torch.where(s > score_threshold, s, 0.0)
    return select_topk_binned(s, bin_size, k_per_bin, k_total)
