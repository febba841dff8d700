"""Training losses of the keypoint / descriptor heads.

Counterpart of ``vit_colmap_tpu/losses/feature_losses.py``:

* :func:`detector_loss`: BCE-with-logits on the dense score heatmap,
  positive-class balanced (a dynamic ``pos_weight`` = negative mass over
  positive mass, clipped to [1, 100], unless one is given), plus a circular
  L2 orientation loss at the keypoints weighted by ``alpha_orient``;
* :func:`descriptor_loss`: positive cosine loss, triplet against the
  hardest negative (margin 0.5), InfoNCE over {positive} + negatives and a
  per-dimension variance hinge, with optional per-point weights;
* :func:`total_loss`: ``lambda_det * det + lambda_desc * desc``, the
  descriptor term weighted by the detached detection confidence
  ``sigmoid(score_at_kp)`` times the validity mask.

The reference's ``stop_gradient``s are ``detach()`` here: the telemetry
scalars ``score_peak`` and ``desc_std``, and the confidence weight.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable elementwise binary cross-entropy with logits."""
    return (torch.clamp_min(logits, 0.0) - logits * targets
            + torch.log1p(torch.exp(-torch.abs(logits))))


def circular_l2(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Squared angular difference via atan2(sin, cos), wrap-safe."""
    d = torch.atan2(torch.sin(pred - target), torch.cos(pred - target))
    return d * d


def detector_loss(
    score_logits: torch.Tensor,  # (B, H, W)
    score_target: torch.Tensor,  # (B, H, W) in [0, 1]
    orient_pred: torch.Tensor,  # (B, K) sampled at keypoints
    orient_target: torch.Tensor,  # (B, K)
    kp_mask: Optional[torch.Tensor] = None,  # (B, K)
    alpha_orient: float = 0.32,
    pos_weight: Optional[float] = None,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Balanced BCE on the score heatmap + circular orientation L2,
    normalized by the total cell weight."""
    t, x = score_target, score_logits
    if pos_weight is None:
        pos_mass = torch.sum(t)
        neg_mass = torch.sum(1.0 - t)
        pw = torch.clamp(neg_mass / torch.clamp_min(pos_mass, 1.0), 1.0, 100.0)
    else:
        pw = torch.as_tensor(pos_weight, dtype=x.dtype, device=x.device)
    per_cell = pw * t * F.softplus(-x) + (1.0 - t) * F.softplus(x)
    cell_w = pw * t + (1.0 - t)
    score_l = torch.sum(per_cell) / torch.clamp_min(torch.sum(cell_w), 1.0)
    o = circular_l2(orient_pred, orient_target)
    if kp_mask is not None:
        m = kp_mask.to(o.dtype)
        orient_l = torch.sum(o * m) / torch.clamp_min(torch.sum(m), 1.0)
    else:
        orient_l = torch.mean(o)
    total = score_l + alpha_orient * orient_l
    # Collapse telemetry: the per-image peak detection probability.
    score_peak = torch.mean(torch.sigmoid(x).amax(dim=(1, 2)))
    return total, {
        "score_loss": score_l,
        "orient_loss": orient_l,
        "score_peak": score_peak.detach(),
    }


def descriptor_loss(
    desc1: torch.Tensor,  # (B, K, D) L2-normalized anchors
    desc2: torch.Tensor,  # (B, K, D) positives
    negatives: torch.Tensor,  # (B, K, N, D) per-anchor negative sets
    weights: Optional[torch.Tensor] = None,  # (B, K)
    margin: float = 0.5,
    hardest: bool = True,
    temperature: float = 0.1,
    lambda_nce: float = 1.0,
    lambda_var: float = 1.0,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Positive cosine + hardest-negative triplet + InfoNCE (per point,
    weighted) + the variance hinge on each descriptor dimension's spread
    (target 1/sqrt(D), the isotropic spread of unit vectors)."""
    pos_sim = torch.sum(desc1 * desc2, dim=-1)  # (B, K)
    pos_loss = 1.0 - pos_sim

    neg_sim = torch.einsum("bkd,bknd->bkn", desc1, negatives)  # (B, K, N)
    pos_dist = 1.0 - pos_sim
    neg_dist = 1.0 - neg_sim
    neg_dist_r = neg_dist.amin(dim=-1) if hardest else neg_dist.mean(dim=-1)
    triplet = torch.clamp_min(pos_dist - neg_dist_r + margin, 0.0)

    logits = torch.cat([pos_sim[..., None], neg_sim], dim=-1) / temperature
    nce = torch.logsumexp(logits, dim=-1) - logits[..., 0]  # (B, K)

    per_point = pos_loss + triplet + lambda_nce * nce
    if weights is not None:
        w = weights / torch.clamp_min(torch.sum(weights, dim=-1, keepdim=True), 1e-8)

        def wmean(v):
            return torch.mean(torch.sum(v * w, dim=-1))
    else:

        def wmean(v):
            return torch.mean(v)

    total = wmean(per_point)

    def var_hinge(d):
        flat = d.reshape(-1, d.shape[-1])  # (B*K, D)
        std = torch.sqrt(torch.var(flat, dim=0, unbiased=False) + 1e-6)
        gamma = 1.0 / torch.sqrt(torch.tensor(float(d.shape[-1]), dtype=d.dtype,
                                              device=d.device))
        return torch.mean(F.relu(1.0 - std / gamma)), torch.mean(std)

    v1, std1 = var_hinge(desc1)
    v2, std2 = var_hinge(desc2)
    var_total = 0.5 * (v1 + v2)
    total = total + lambda_var * var_total
    return total, {
        "positive_loss": wmean(pos_loss),
        "triplet_loss": wmean(triplet),
        "nce_loss": wmean(nce),
        "variance_loss": var_total,
        # Collapse telemetry: mean per-dimension spread (healthy ~ 1/sqrt(D)).
        "desc_std": (0.5 * (std1 + std2)).detach(),
    }


class LossOutput(NamedTuple):
    total: torch.Tensor
    components: dict[str, torch.Tensor]


def total_loss(
    outputs: dict[str, torch.Tensor],
    targets: dict[str, torch.Tensor],
    lambda_det: float = 1.0,
    lambda_desc: float = 1.0,
    alpha_orient: float = 0.32,
    margin: float = 0.5,
    temperature: float = 0.1,
    lambda_nce: float = 1.0,
    lambda_var: float = 1.0,
    pos_weight: Optional[float] = None,
) -> LossOutput:
    """outputs: score_logits (B, H, W), orient_pred (B, K), desc1 / desc2
    (B, K, D), negatives (B, K, N, D), score_at_kp (B, K) logits at the
    invariant points; targets: score_target (B, H, W), orient_target
    (B, K), kp_mask (B, K)."""
    det, det_parts = detector_loss(
        outputs["score_logits"],
        targets["score_target"],
        outputs["orient_pred"],
        targets["orient_target"],
        targets.get("kp_mask"),
        alpha_orient,
        pos_weight=pos_weight,
    )
    # The confidence carries no gradient: the descriptor loss must not
    # reward lowering the scores at hard points.
    conf = torch.sigmoid(outputs["score_at_kp"].detach())
    kp_mask = targets.get("kp_mask")
    if kp_mask is not None:
        conf = conf * kp_mask
    desc, desc_parts = descriptor_loss(
        outputs["desc1"],
        outputs["desc2"],
        outputs["negatives"],
        weights=conf,
        margin=margin,
        temperature=temperature,
        lambda_nce=lambda_nce,
        lambda_var=lambda_var,
    )
    total = lambda_det * det + lambda_desc * desc
    return LossOutput(total, {"detector_loss": det, "descriptor_loss": desc,
                              **det_parts, **desc_parts})
