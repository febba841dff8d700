"""Deterministic, persistable PCA fitting for ViT-family extractors.

Counterpart of ``vit_colmap_tpu/features/pca_store.py``: the projection is
fitted once on the patch tokens of the first ``fit_images`` images in
sorted-name order, and optionally saved to / loaded from an ``.npz`` in the
JAX package's format, so descriptors do not depend on arrival order.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from vit_colmap_tpu_torch.models.dinov2 import patch_grid_size
from vit_colmap_tpu_torch.ops.interpolate import fit_pca, load_pca, save_pca
from vit_colmap_tpu_torch.utils.image_io import resize_area

logger = logging.getLogger(__name__)

MAX_FIT_TOKENS = 262_144  # cap covariance accumulation work


def fit_pca_deterministic(
    dense_fn: Callable[[np.ndarray], torch.Tensor],
    rgbs: Sequence[np.ndarray],
    out_dim: int,
    fit_images: int = 8,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fit PCA on the patch tokens of the first ``fit_images`` of ``rgbs``
    (already in canonical order).  ``dense_fn`` maps a (B, H, W, 3) uint8
    batch to a (B, gh, gw, C) feature map; beyond MAX_FIT_TOKENS tokens a
    fixed stride keeps the fit bounded and deterministic."""
    groups: dict[tuple[int, int], list[np.ndarray]] = {}
    subset = list(rgbs[: max(1, fit_images)])
    for rgb in subset:
        oh, ow = rgb.shape[:2]
        th, tw = patch_grid_size(oh, ow)
        groups.setdefault((th, tw), []).append(resize_area(rgb, tw, th))
    chunks = []
    for _, imgs in sorted(groups.items()):
        fmap = dense_fn(np.stack(imgs))
        chunks.append(fmap.float().reshape(-1, fmap.shape[-1]))
    tokens = torch.cat(chunks, dim=0)
    if tokens.shape[0] > MAX_FIT_TOKENS:
        stride = int(np.ceil(tokens.shape[0] / MAX_FIT_TOKENS))
        tokens = tokens[::stride]
    logger.info("Fitting PCA %d->%d on %d tokens from %d images",
                tokens.shape[1], out_dim, tokens.shape[0], len(subset))
    return fit_pca(tokens, out_dim)


def resolve_pca(
    pca_path: Optional[str],
    fit: Callable[[], tuple[torch.Tensor, torch.Tensor]],
    device=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Load the PCA at ``pca_path`` if it exists; otherwise ``fit()`` and
    save the result there (when given)."""
    if pca_path and Path(pca_path).exists():
        logger.info("Loading persisted PCA from %s", pca_path)
        return load_pca(pca_path, device)
    comps, mean = fit()
    if pca_path:
        Path(pca_path).parent.mkdir(parents=True, exist_ok=True)
        save_pca(pca_path, comps, mean)
        logger.info("Saved fitted PCA to %s", pca_path)
    return comps, mean
