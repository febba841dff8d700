"""HPatches-style homography evaluation: MMA and homography accuracy.

Counterpart of ``vit_colmap_tpu/utils/homography_eval.py``:

* **MMA@t**: the share of matches whose ground-truth reprojection error is
  at most t pixels, averaged over pairs;
* **homography accuracy@t**: the share of pairs whose RANSAC homography
  warps the four image corners within t pixels (mean) of the ground
  truth's warp.

RANSAC is the port's (``ops/ransac``: 4-point DLT hypotheses in chunks of
128 with the adaptive exit, one weighted refit), on uniforms drawn from
``torch.Generator().manual_seed(seed)`` in place of ``jax.random.key(seed)``,
or on the caller's ``uniforms`` (the tests pass the JAX package's).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from vit_colmap_tpu_torch.dataloader.homography_utils import apply_homography
from vit_colmap_tpu_torch.device import exact_f32_matmuls, resolve_device
from vit_colmap_tpu_torch.ops.ransac import RANSAC_CHUNK, _one_model, _ransac
from vit_colmap_tpu_torch.sfm import geometry as geom

logger = logging.getLogger(__name__)

DEFAULT_THRESHOLDS = (1.0, 3.0, 5.0)


@dataclass
class PairEval:
    num_matches: int
    match_errors: np.ndarray  # GT reprojection error per match (px)
    corner_error: float  # estimated-vs-GT corner warp error (px)


@dataclass
class HomographyEvalResult:
    thresholds: tuple[float, ...]
    pairs: list[PairEval] = field(default_factory=list)

    @property
    def mma(self) -> dict[float, float]:
        out = {}
        for t in self.thresholds:
            accs = [float((p.match_errors <= t).mean()) for p in self.pairs
                    if len(p.match_errors)]
            out[t] = float(np.mean(accs)) if accs else 0.0
        return out

    @property
    def homography_accuracy(self) -> dict[float, float]:
        out = {}
        errs = [p.corner_error for p in self.pairs]
        for t in self.thresholds:
            out[t] = float(np.mean([e <= t for e in errs])) if errs else 0.0
        return out

    @property
    def avg_matches(self) -> float:
        return float(np.mean([p.num_matches for p in self.pairs])) if self.pairs else 0.0

    def summary(self) -> str:
        return "\n".join([
            f"pairs: {len(self.pairs)}, avg matches: {self.avg_matches:.1f}",
            "MMA:      " + "  ".join(f"@{t:g}px {v:.3f}" for t, v in self.mma.items()),
            "H-acc:    " + "  ".join(
                f"@{t:g}px {v:.3f}" for t, v in self.homography_accuracy.items()),
        ])


def _warp(H: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """float32 H applied to (N, 2) points, on the CPU."""
    H = torch.as_tensor(np.asarray(H, np.float32))
    return apply_homography(H[None], torch.as_tensor(np.asarray(pts, np.float32))[None])[0].numpy()


def match_reprojection_errors(kpts1: np.ndarray, kpts2: np.ndarray, matches: np.ndarray,
                              H_gt: np.ndarray) -> np.ndarray:
    """GT error of each match: ||H x1 - x2|| in pixels."""
    if len(matches) == 0:
        return np.zeros(0, np.float32)
    warped = _warp(H_gt, kpts1[matches[:, 0], :2])
    return np.linalg.norm(warped - kpts2[matches[:, 1], :2], axis=-1)


def ransac_chunks(iters: int) -> tuple[int, int]:
    """(chunks, chunk size) the homography RANSAC may run for ``iters``."""
    chunk = min(RANSAC_CHUNK, iters)
    return -(-iters // chunk), chunk


def estimate_homography_corner_error(
    kpts1: np.ndarray,
    kpts2: np.ndarray,
    matches: np.ndarray,
    H_gt: np.ndarray,
    image_wh: tuple[int, int],
    iters: int = 512,
    max_error_px: float = 3.0,
    seed: int = 0,
    uniforms: Optional[torch.Tensor] = None,
    device=None,
) -> float:
    """RANSAC-estimate H from the matches; the mean corner-warp error
    against the ground truth (inf with fewer than 4 matches or inliers).
    ``uniforms`` (chunks, chunk size, 4) in [0, 1) (:func:`ransac_chunks`)
    replaces the draws from ``seed``."""
    if len(matches) < 4:
        return float("inf")
    dev = resolve_device(device)
    k_max = 1
    while k_max < len(matches):
        k_max *= 2
    p1 = np.zeros((k_max, 2), np.float32)
    p2 = np.zeros((k_max, 2), np.float32)
    mask = np.zeros(k_max, bool)
    p1[: len(matches)] = kpts1[matches[:, 0], :2]
    p2[: len(matches)] = kpts2[matches[:, 1], :2]
    mask[: len(matches)] = True
    if uniforms is None:
        n, chunk = ransac_chunks(iters)
        uniforms = torch.rand((n, chunk, 4), generator=torch.Generator().manual_seed(seed))
    thresh = torch.full((1,), max_error_px**2, dtype=torch.float32, device=dev)
    with exact_f32_matmuls():
        H_est, _, n_inl = _ransac(
            _one_model(geom.fit_homography), geom.fit_homography, geom.homography_error,
            torch.from_numpy(p1)[None].to(dev), torch.from_numpy(p2)[None].to(dev),
            torch.from_numpy(mask)[None].to(dev), uniforms[None].to(dev), iters, 4, thresh,
            0.999)
    if int(n_inl[0]) < 4:
        return float("inf")
    w, h = image_wh
    corners = np.array([[0, 0], [w - 1, 0], [w - 1, h - 1], [0, h - 1]], np.float32)
    c_est = _warp(H_est[0].cpu().numpy(), corners)
    c_gt = _warp(H_gt, corners)
    return float(np.linalg.norm(c_est - c_gt, axis=-1).mean())


def evaluate_pairs(pair_data: Sequence[dict],
                   thresholds: Sequence[float] = DEFAULT_THRESHOLDS,
                   device=None) -> HomographyEvalResult:
    """pair_data entries: {kpts1, kpts2, matches (R, 2), H (3, 3), image_wh}."""
    result = HomographyEvalResult(tuple(thresholds))
    for d in pair_data:
        errs = match_reprojection_errors(d["kpts1"], d["kpts2"], d["matches"], d["H"])
        corner = estimate_homography_corner_error(d["kpts1"], d["kpts2"], d["matches"],
                                                  d["H"], d["image_wh"], device=device)
        result.pairs.append(PairEval(num_matches=len(d["matches"]), match_errors=errs,
                                     corner_error=corner))
    return result
