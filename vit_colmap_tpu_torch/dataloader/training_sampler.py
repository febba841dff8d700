"""Invariant-point selection and negative mining, batched.

Counterpart of ``vit_colmap_tpu/dataloader/training_sampler.py``:

* invariant points: the warped cosine-similarity map (plus an optional
  image-structure prior) -> the top-k cells of image 2, transferred to
  image 1 through H^-1;
* in-image negatives: uniformly drawn cells of image 2, any candidate
  closer than ``min_dist`` to its anchor replaced by the anchor's antipode
  (similarity -1: never the hardest negative);
* cross-image negatives: uniformly drawn cells of the previous image of
  the batch (the batch rolled by one);
* hard negatives: the ``top_n`` most similar cells of image 2's
  descriptor map at least ``min_dist`` from the anchor.

Top-k takes the lower index first among equal values, as ``lax.top_k``
does (``ops/detect.top_k``).  Random draws come from a ``torch.Generator``
in place of a ``jax.random`` key, or from any callable ``shape -> uniforms
in [0, 1)`` (:func:`draw_uniform`), through which the tests feed the JAX
package's draws; the draws are taken in the reference's order of keys.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Union

import torch

from vit_colmap_tpu_torch.dataloader.homography_utils import (
    apply_homography,
    feature_similarity_map,
    grid_to_image,
    image_to_grid,
    in_grid,
)
from vit_colmap_tpu_torch.ops.detect import top_k as stable_top_k
from vit_colmap_tpu_torch.ops.interpolate import bilinear_sample, l2_normalize

# A torch.Generator, or a callable shape -> uniforms in [0, 1).
UniformSource = Union[torch.Generator, Callable[[tuple], torch.Tensor]]


def draw_uniform(generator: UniformSource, shape: tuple, device) -> torch.Tensor:
    """Uniforms in [0, 1) of ``shape`` on ``device``: drawn from a
    ``torch.Generator`` on its own device, or returned by a callable."""
    if isinstance(generator, torch.Generator):
        return torch.rand(shape, generator=generator, device=generator.device).to(device)
    return torch.as_tensor(generator(tuple(shape)), dtype=torch.float32).to(device)


class InvariantPoints(NamedTuple):
    coords2_grid: torch.Tensor  # (B, K, 2) feature-grid coords in image 2
    coords1_grid: torch.Tensor  # (B, K, 2) transferred coords in image 1
    similarity: torch.Tensor  # (B, K)
    valid: torch.Tensor  # (B, K)


def select_invariant_points(
    feats1: torch.Tensor,  # (B, gh, gw, C)
    feats2: torch.Tensor,
    H12: torch.Tensor,  # (B, 3, 3) image-1 -> image-2 pixels
    top_k: int = 512,
    threshold: float = 0.0,
    patch: int = 14,
    structure2: Optional[torch.Tensor] = None,  # (B, gh, gw) in [0, 1]
    structure_alpha: float = 1.0,
) -> InvariantPoints:
    """The top-k cells of image 2 by the similarity of warped image-1
    features with image-2 features, plus ``structure_alpha * structure2``
    when a structure prior is given (cells outside the overlap then score
    -2, below every valid cell).  A point is valid when its score exceeds
    ``threshold`` and its transfer lies inside image 1's grid."""
    B, gh, gw, _ = feats1.shape
    sim, valid = feature_similarity_map(feats1, feats2, H12, patch)
    sel = sim
    if structure2 is not None and structure_alpha > 0.0:
        sel = torch.where(valid, sim + structure_alpha * structure2,
                          torch.full_like(sim, -2.0))
    top_sim, idx = stable_top_k(sel.reshape(B, -1), top_k)
    ys = torch.div(idx, gw, rounding_mode="floor").float()
    xs = (idx % gw).float()
    coords2 = torch.stack([xs, ys], dim=-1)
    pts1_img = apply_homography(torch.linalg.inv(H12), grid_to_image(coords2, patch))
    coords1 = image_to_grid(pts1_img, patch)
    ok = (top_sim > threshold) & in_grid(coords1, gh, gw)
    return InvariantPoints(coords2, coords1, top_sim, ok)


def sample_features_at(fmap: torch.Tensor, coords_grid: torch.Tensor) -> torch.Tensor:
    """Bilinear feature sampling at grid coords: (B, H, W, C), (B, K, 2) ->
    (B, K, C)."""
    return bilinear_sample(fmap, coords_grid)


def _random_cells(generator: UniformSource, B: int, K: int, num: int, H: int, W: int,
                  device) -> torch.Tensor:
    """(B, K, num, 2) uniformly drawn map coordinates: x from the first
    draw, y from the second (the reference's split key order)."""
    xs = draw_uniform(generator, (B, K, num), device) * (W - 1)
    ys = draw_uniform(generator, (B, K, num), device) * (H - 1)
    return torch.stack([xs, ys], dim=-1)


def in_image_negatives(
    desc_map2: torch.Tensor,  # (B, H, W, D) L2-normalized descriptor map
    anchor_coords2: torch.Tensor,  # (B, K, 2) grid coords of the true matches
    anchor_desc: torch.Tensor,  # (B, K, D)
    generator: UniformSource,
    num_neg: int = 8,
    min_dist: float = 16.0 / 14.0,
) -> torch.Tensor:
    """Random same-image negatives (B, K, num_neg, D); candidates nearer
    than ``min_dist`` cells become the anchor's antipode."""
    B, H, W, D = desc_map2.shape
    K = anchor_coords2.shape[1]
    cand = _random_cells(generator, B, K, num_neg, H, W, desc_map2.device)
    far = torch.linalg.vector_norm(cand - anchor_coords2[:, :, None, :], dim=-1) >= min_dist
    desc = bilinear_sample(desc_map2, cand.reshape(B, K * num_neg, 2)).reshape(B, K, num_neg, D)
    desc = torch.where(far[..., None], desc, -anchor_desc[:, :, None, :])
    return l2_normalize(desc)


def cross_image_negatives(desc_map2: torch.Tensor, generator: UniformSource, K: int,
                          num_neg: int = 4) -> torch.Tensor:
    """Random cells of the previous image of the batch (rolled by one):
    (B, K, num_neg, D)."""
    B, H, W, D = desc_map2.shape
    rolled = torch.roll(desc_map2, shifts=1, dims=0)
    cand = _random_cells(generator, B, K, num_neg, H, W, desc_map2.device)
    desc = bilinear_sample(rolled, cand.reshape(B, K * num_neg, 2)).reshape(B, K, num_neg, D)
    return l2_normalize(desc)


def _hard_negative_topk(desc_map2, anchor_coords2, anchor_desc, top_n: int = 4,
                        min_dist: float = 16.0 / 14.0):
    """(similarities, flat cell indices) (B, K, top_n) of the most similar
    cells at least ``min_dist`` from the anchor."""
    B, H, W, D = desc_map2.shape
    with torch.no_grad():
        sim = torch.einsum("bkd,bnd->bkn", anchor_desc, desc_map2.reshape(B, H * W, D))
        cells = torch.arange(H * W, device=desc_map2.device)
        xy = torch.stack([(cells % W).float(),
                          torch.div(cells, W, rounding_mode="floor").float()], dim=-1)
        d = torch.linalg.vector_norm(xy[None, None] - anchor_coords2[:, :, None, :], dim=-1)
        sim = torch.where(d >= min_dist, sim, torch.full_like(sim, -torch.inf))
        return stable_top_k(sim, top_n)


def hard_negatives(
    desc_map2: torch.Tensor,  # (B, H, W, D)
    anchor_coords2: torch.Tensor,  # (B, K, 2)
    anchor_desc: torch.Tensor,  # (B, K, D)
    top_n: int = 4,
    min_dist: float = 16.0 / 14.0,
) -> torch.Tensor:
    """The most similar but geometrically far cells' descriptors,
    (B, K, top_n, D); the gradient reaches the map through the gather."""
    B, H, W, D = desc_map2.shape
    _, idx = _hard_negative_topk(desc_map2, anchor_coords2, anchor_desc, top_n, min_dist)
    batch = torch.arange(B, device=idx.device)[:, None, None]
    return l2_normalize(desc_map2.reshape(B, H * W, D)[batch, idx])


def hard_negative_coords(desc_map2, anchor_coords2, anchor_desc, top_n: int = 4,
                         min_dist: float = 16.0 / 14.0):
    """(coords (B, K, top_n, 2) grid xy, similarity (B, K, top_n)) of the
    hard negatives, for analysis tools."""
    W = desc_map2.shape[2]
    sim, idx = _hard_negative_topk(desc_map2, anchor_coords2, anchor_desc, top_n, min_dist)
    xy = torch.stack([(idx % W).float(), torch.div(idx, W, rounding_mode="floor").float()],
                     dim=-1)
    return xy, sim


def generate_all_negatives(desc_map2, anchor_coords2, anchor_desc, generator: UniformSource,
                           num_in_image: int = 8, num_cross: int = 4, num_hard: int = 4):
    """In-image, cross-image and hard negatives concatenated:
    (B, K, num_in_image + num_cross + num_hard, D)."""
    K = anchor_coords2.shape[1]
    negs = [
        in_image_negatives(desc_map2, anchor_coords2, anchor_desc, generator, num_in_image),
        cross_image_negatives(desc_map2, generator, K, num_cross),
        hard_negatives(desc_map2, anchor_coords2, anchor_desc, num_hard),
    ]
    return torch.cat(negs, dim=2)
