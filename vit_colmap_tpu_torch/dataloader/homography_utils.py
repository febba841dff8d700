"""Homography warping of ViT patch-token grids.

Counterpart of ``vit_colmap_tpu/dataloader/homography_utils.py``:
homographies act on image pixel coordinates (x, y), and feature-grid cell
(i, j) has its centre at image pixel ((j + 0.5) * patch, (i + 0.5) *
patch).  Image-1 tokens are warped backwards into image 2's frame through
H^-1 at the cell centres, read bilinearly with the border clamped
(``ops/interpolate.bilinear_sample``), with a mask of the cells whose
source lies inside the grid.
"""

from __future__ import annotations

import torch

from vit_colmap_tpu_torch.models.dinov2 import PATCH_SIZE
from vit_colmap_tpu_torch.ops.interpolate import bilinear_sample, l2_normalize

# Float tolerance at the exact border of the grid, in cells.
BORDER_EPS = 1e-3


def apply_homography(H: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """H (..., 3, 3) applied to pts (..., N, 2) -> (..., N, 2)."""
    ph = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
    out = torch.einsum("...ij,...nj->...ni", H, ph)
    w = out[..., 2:]
    return out[..., :2] / torch.where(torch.abs(w) > 1e-8, w, torch.full_like(w, 1e-8))


def grid_centers(gh: int, gw: int, patch: int = PATCH_SIZE, device=None) -> torch.Tensor:
    """(gh * gw, 2) image-pixel centres of the feature-grid cells, row-major."""
    ys = (torch.arange(gh, dtype=torch.float32, device=device) + 0.5) * patch
    xs = (torch.arange(gw, dtype=torch.float32, device=device) + 0.5) * patch
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=-1)


def divide(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d, correctly rounded on every device.  PyTorch divides a card
    tensor by a Python scalar as a product with the scalar's reciprocal,
    which rounds apart from the CPU's division; a 0-d tensor on the card
    takes the division."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def image_to_grid(pts_img: torch.Tensor, patch: int = PATCH_SIZE) -> torch.Tensor:
    """Image pixels -> continuous feature-grid coordinates (x_g, y_g)."""
    return divide(pts_img, patch) - 0.5


def grid_to_image(pts_grid: torch.Tensor, patch: int = PATCH_SIZE) -> torch.Tensor:
    return (pts_grid + 0.5) * patch


def in_grid(coords: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    """(..., 2) grid coordinates -> (...) inside [0, gw-1] x [0, gh-1], with
    BORDER_EPS of slack."""
    eps = BORDER_EPS
    return ((coords[..., 0] >= -eps) & (coords[..., 0] <= gw - 1 + eps)
            & (coords[..., 1] >= -eps) & (coords[..., 1] <= gh - 1 + eps))


def warp_patch_tokens(
    feats1: torch.Tensor,  # (B, gh, gw, C) tokens of image 1
    H12: torch.Tensor,  # (B, 3, 3) image-1 pixels -> image-2 pixels
    patch: int = PATCH_SIZE,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Backward-warp image-1 tokens into image 2's frame: output cell (i, j)
    is feats1 read at H12^-1(centre2(i, j)).  Returns (warped (B, gh, gw,
    C), valid (B, gh, gw))."""
    B, gh, gw, C = feats1.shape
    centers2 = grid_centers(gh, gw, patch, feats1.device).expand(B, gh * gw, 2)
    pts1_grid = image_to_grid(apply_homography(torch.linalg.inv(H12), centers2), patch)
    warped = bilinear_sample(feats1, pts1_grid)
    return warped.reshape(B, gh, gw, C), in_grid(pts1_grid, gh, gw).reshape(B, gh, gw)


def feature_similarity_map(feats1: torch.Tensor, feats2: torch.Tensor, H12: torch.Tensor,
                           patch: int = PATCH_SIZE) -> tuple[torch.Tensor, torch.Tensor]:
    """Cosine similarity of warped feats1 and feats2 per cell: (sim (B, gh,
    gw) in [-1, 1], -1 outside the overlap; valid (B, gh, gw))."""
    warped, valid = warp_patch_tokens(feats1, H12, patch)
    sim = torch.sum(l2_normalize(warped) * l2_normalize(feats2), dim=-1)
    return torch.where(valid, sim, torch.full_like(sim, -1.0)), valid


def compose_homographies(H_1i: torch.Tensor, H_1j: torch.Tensor) -> torch.Tensor:
    """H_i_j = H_1_j @ inv(H_1_i)."""
    return H_1j @ torch.linalg.inv(H_1i)


def adjust_homography_for_resize(H: torch.Tensor, scale_x1: float, scale_y1: float,
                                 scale_x2: float, scale_y2: float) -> torch.Tensor:
    """H' = S2 @ H @ S1^-1 when both images are resized."""
    S1 = torch.diag(torch.tensor([scale_x1, scale_y1, 1.0], dtype=H.dtype, device=H.device))
    S2 = torch.diag(torch.tensor([scale_x2, scale_y2, 1.0], dtype=H.dtype, device=H.device))
    return S2 @ H @ torch.linalg.inv(S1)


def homography_rotation_angle(H: torch.Tensor) -> torch.Tensor:
    """In-plane rotation angle atan2(H10, H00)."""
    return torch.atan2(H[..., 1, 0], H[..., 0, 0])
