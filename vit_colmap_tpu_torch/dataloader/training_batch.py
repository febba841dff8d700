"""One training batch: backbone features, invariant points, negatives,
head outputs and targets.

Counterpart of ``vit_colmap_tpu/dataloader/training_batch.py``: the
backbone once per image (without gradient unless ``train_backbone``),
invariant-point selection with an image-structure prior, the heads on both
images, coordinates carried from the feature grid (1/14) to the heads'
quarter-resolution map (x3.5), descriptors and negatives from the real
descriptor head, the gradient-direction orientation target rotated by the
homography's in-plane angle, and the Gaussian score heatmap.  With
``train_backbone`` it adds the dense InfoNCE on raw backbone tokens.

Modules take the place of the reference's (apply, params) pairs, and a
``torch.Generator`` (or a callable, see ``training_sampler.draw_uniform``)
the place of its key: the draws are taken in the reference's order (the
in-image negatives' x and y, the cross-image negatives' x and y, then the
token loss's x and y).
"""

from __future__ import annotations

import torch

from vit_colmap_tpu_torch.dataloader.homography_utils import (
    apply_homography,
    divide,
    grid_to_image,
    homography_rotation_angle,
    image_to_grid,
    in_grid,
)
from vit_colmap_tpu_torch.dataloader.training_sampler import (
    UniformSource,
    draw_uniform,
    generate_all_negatives,
    sample_features_at,
    select_invariant_points,
)
from vit_colmap_tpu_torch.models.dinov2 import PATCH_SIZE, preprocess
from vit_colmap_tpu_torch.ops.interpolate import l2_normalize
from vit_colmap_tpu_torch.utils.orientation import (
    compute_keypoint_orientations_simple,
    rgb_to_gray,
)

# Feature-grid (1/14) -> head-output (1/4) coordinate scale.
GRID_TO_HEAD = PATCH_SIZE / 4.0  # 3.5

# Keypoints per slice of the heatmap's distance computation (bounds its
# memory to HEATMAP_CHUNK maps at a time).
HEATMAP_CHUNK = 64


def gaussian_heatmap(
    coords: torch.Tensor,  # (B, K, 2) in heatmap coords
    valid: torch.Tensor,  # (B, K)
    height: int,
    width: int,
    sigma: float = 1.0,
) -> torch.Tensor:
    """The max over valid keypoints of a Gaussian at each, (B, height,
    width).  exp is monotone, so the max is the exp of the nearest valid
    keypoint's squared distance, found a slice of keypoints at a time."""
    ys = torch.arange(height, dtype=torch.float32, device=coords.device)
    xs = torch.arange(width, dtype=torch.float32, device=coords.device)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    nearest = torch.full((coords.shape[0], height, width), torch.inf, device=coords.device)
    for s in range(0, coords.shape[1], HEATMAP_CHUNK):
        c = coords[:, s:s + HEATMAP_CHUNK]
        dx = xx[None, None] - c[..., 0][:, :, None, None]
        dy = yy[None, None] - c[..., 1][:, :, None, None]
        d2 = torch.where(valid[:, s:s + HEATMAP_CHUNK, None, None], dx * dx + dy * dy,
                         torch.full_like(dx, torch.inf))
        nearest = torch.minimum(nearest, d2.amin(dim=1))
    return torch.exp(-nearest / (2.0 * sigma * sigma))


def gray01(img: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, H, W) luminance in [0, 1], divided by 255
    with the same rounding on the card and the CPU (``homography_utils.
    divide``): the orientation target is atan2 of its differences."""
    return divide(rgb_to_gray(img), 255.0)


def image_structure_grid(img: torch.Tensor, gh: int, gw: int, patch: int = 14) -> torch.Tensor:
    """Per-feature-cell image cornerness in [0, 1]: the Harris response of
    the gray image, clipped at 0, max-pooled over each cell and divided by
    the image's largest cell."""
    from vit_colmap_tpu_torch.ops.scoring import harris_response

    resp = torch.clamp_min(harris_response(gray01(img)), 0.0)[:, : gh * patch, : gw * patch]
    resp = resp.reshape(resp.shape[0], gh, patch, gw, patch).amax(dim=(2, 4))
    mx = resp.reshape(resp.shape[0], -1).amax(dim=-1)
    return resp / torch.clamp_min(mx[:, None, None], 1e-12)


def dense_token_loss(
    feats1: torch.Tensor,  # (B, gh, gw, C) raw backbone patch tokens
    feats2: torch.Tensor,
    H12: torch.Tensor,  # (B, 3, 3) image-1 -> image-2 pixels
    generator: UniformSource,
    num_cells: int = 256,
    temperature: float = 0.1,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Symmetric InfoNCE on raw backbone tokens at ground-truth
    correspondences: ``num_cells`` cells drawn uniformly in image 2, mapped
    through H^-1, tokens read bilinearly in both images; rows whose image-1
    point leaves the grid are dropped, and so are their columns in the
    image-2 -> image-1 direction."""
    B, gh, gw, _ = feats1.shape
    xs = draw_uniform(generator, (B, num_cells), feats1.device) * (gw - 1.0)
    ys = draw_uniform(generator, (B, num_cells), feats1.device) * (gh - 1.0)
    coords2 = torch.stack([xs, ys], dim=-1)
    coords1 = image_to_grid(apply_homography(torch.linalg.inv(H12), grid_to_image(coords2)))
    ok = in_grid(coords1, gh, gw)

    t1 = l2_normalize(sample_features_at(feats1, coords1))
    t2 = l2_normalize(sample_features_at(feats2, coords2))
    logits = torch.einsum("bkd,bld->bkl", t1, t2) / temperature
    diag = torch.diagonal(logits, dim1=1, dim2=2)
    w = ok.float()
    denom = torch.clamp_min(w.sum(dim=-1), 1.0)
    nce12 = torch.logsumexp(logits, dim=-1) - diag
    col_mask = torch.where(ok[:, None, :], 0.0, -1e9)
    nce21 = torch.logsumexp(logits + col_mask, dim=-2) - diag
    loss = 0.5 * torch.mean(torch.sum((nce12 + nce21) * w, dim=-1) / denom)
    pos_sim = torch.sum(torch.sum(t1 * t2, dim=-1) * w, dim=-1) / denom
    return loss, {"token_loss": loss, "token_pos_sim": pos_sim.mean().detach()}


def process_batch(
    backbone,
    heads,
    batch: dict[str, torch.Tensor],
    generator: UniformSource,
    top_k: int = 512,
    num_in_image: int = 8,
    num_cross: int = 4,
    num_hard: int = 4,
    structure_alpha: float = 1.0,
    train_backbone: bool = False,
) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    """image1 / image2 (B, H, W, 3) uint8 and H (B, 3, 3) on one device ->
    (outputs, targets) for :func:`vit_colmap_tpu_torch.losses.
    feature_losses.total_loss`.  ``backbone`` maps normalized images to
    ``x_norm_patchtokens`` and ``grid``; ``heads`` maps (B, gh, gw, C)
    tokens to the quarter-resolution maps."""
    img1, img2, H12 = batch["image1"], batch["image2"], batch["H"]
    B = img1.shape[0]

    def backbone_feats(img):
        with torch.set_grad_enabled(train_backbone and torch.is_grad_enabled()):
            out = backbone(preprocess(img))
        gh, gw = out["grid"]
        return out["x_norm_patchtokens"].reshape(B, gh, gw, -1)

    feats1 = backbone_feats(img1)
    feats2 = backbone_feats(img2)

    structure2 = None
    if structure_alpha > 0.0:
        structure2 = image_structure_grid(img2, feats2.shape[1], feats2.shape[2])
    with torch.no_grad():  # integer selections: no gradient reaches them
        inv = select_invariant_points(feats1, feats2, H12, top_k=top_k,
                                      structure2=structure2, structure_alpha=structure_alpha)

    out1 = heads(feats1)
    out2 = heads(feats2)

    c1_head = inv.coords1_grid * GRID_TO_HEAD
    c2_head = inv.coords2_grid * GRID_TO_HEAD
    desc1 = l2_normalize(sample_features_at(out1["descriptors"], c1_head))
    desc2 = l2_normalize(sample_features_at(out2["descriptors"], c2_head))
    negatives = generate_all_negatives(out2["descriptors"], c2_head, desc1, generator,
                                       num_in_image=num_in_image, num_cross=num_cross,
                                       num_hard=num_hard)

    # Orientation target: image 1's gradient direction at the keypoints,
    # rotated by the homography's in-plane angle.
    with torch.no_grad():
        orient1_gt = compute_keypoint_orientations_simple(gray01(img1),
                                                          grid_to_image(inv.coords1_grid))
        orient2_target = orient1_gt + homography_rotation_angle(H12)[:, None]
        h4, w4 = out2["score_logits"].shape[1:3]
        score_target = gaussian_heatmap(c2_head, inv.valid, h4, w4, sigma=1.0)

    orient2_pred = sample_features_at(out2["orientation"][..., None], c2_head)[..., 0]
    score_at_kp = sample_features_at(out2["score_logits"][..., None], c2_head)[..., 0]

    outputs = {
        "score_logits": out2["score_logits"],
        "orient_pred": orient2_pred,
        "desc1": desc1,
        "desc2": desc2,
        "negatives": negatives,
        "score_at_kp": score_at_kp,
    }
    if train_backbone:
        _, token_aux = dense_token_loss(feats1, feats2, H12, generator)
        outputs.update(token_aux)
    targets = {
        "score_target": score_target,
        "orient_target": orient2_target,
        "kp_mask": inv.valid.float(),
    }
    return outputs, targets
