"""Batched RANSAC for two-view geometric verification.

The port's copy of ``vit_colmap_tpu/ops/ransac.py``: F, H and (for
calibrated pairs) E RANSAC over a batch of pairs, each pair a lane, then
COLMAP's E/F/H arbitration into a two-view configuration.

* Minimal samples are drawn without replacement (Floyd shifting) from
  uniforms the caller passes in (:func:`draw_uniforms`), so that the card
  and the CPU, or the port and the reference, can be given the same
  samples.
* Hypotheses run in chunks with a confidence-based early exit per lane
  (stop once 1 - (1 - w^m)^N >= confidence).  The reference vmaps a
  ``lax.while_loop``: every lane keeps its own hypothesis count, only lanes
  whose condition still holds take a chunk's update, and the loop ends when
  no lane is active.  Here that is per-lane state updated through
  ``torch.where`` and one host check per chunk.  Padding lanes and lanes
  with fewer valid correspondences than the sample size exit at once.
* Each chunk fits all its hypotheses in one batched solve and counts
  inliers as one broadcast error evaluation; the best model is refit once
  on its inliers.
* Calibrated pairs run an 8-point E RANSAC first and seed the 5-point loop
  with it: easy lanes satisfy the criterion at entry and skip the 5-point
  solver.

Every fit is f32: :func:`estimate_two_view_batched` runs with TF32 matmuls
off, whatever the caller's global setting.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import NamedTuple, Optional

import torch

from vit_colmap_tpu_torch.database.colmap_db import TWO_VIEW_CONFIG
from vit_colmap_tpu_torch.device import exact_f32_matmuls
from vit_colmap_tpu_torch.sfm import geometry as geom
from vit_colmap_tpu_torch.sfm.five_point import fit_essential_5pt

# COLMAP TwoViewGeometryOptions defaults (two_view_geometry.h).
MIN_E_F_INLIER_RATIO = 0.95
MAX_H_INLIER_RATIO = 0.8
RANSAC_CHUNK = 128


class TwoViewResult(NamedTuple):
    """Two-view estimation of a batch of P pairs."""

    config: torch.Tensor  # (P,) int32, TWO_VIEW_CONFIG enum
    inlier_mask: torch.Tensor  # (P, K) bool, inliers of the winning model
    num_inliers: torch.Tensor  # (P,) int32
    F: torch.Tensor  # (P, 3, 3)
    E: torch.Tensor  # (P, 3, 3)
    H: torch.Tensor  # (P, 3, 3)
    qvec: torch.Tensor  # (P, 4) relative pose (if calibrated)
    tvec: torch.Tensor  # (P, 3)


class RansacUniforms(NamedTuple):
    """The uniforms in [0, 1) of every chunk a batch may run, per stream:
    (P, chunks, chunk size, sample size).  Chunk ``s`` of a stream is drawn
    by every lane that runs that chunk (its hypothesis count is then the
    stream's start + s * chunk size).  ``e`` feeds the 8-point E loop (the
    5-point seed, or E itself without the 5-point solver), ``e5`` the
    5-point loop (None without it)."""

    f: torch.Tensor
    h: torch.Tensor
    e: torch.Tensor
    e5: Optional[torch.Tensor]


def chunk_plan(iters: int = 1024, h_iters: int = 256, five_point: bool = True,
               five_point_chunk: int = 16) -> dict:
    """stream -> (chunks, chunk size, sample size, start): the most chunks
    each loop can run.  A loop runs while its hypothesis count, from
    ``start`` in steps of the chunk size, is below its budget; the 5-point
    loop starts at 1, the 8-point seed counting as one hypothesis."""

    def plan(budget, chunk, m, start=0):
        return (max(0, -(-(budget - start) // chunk)), chunk, m, start)

    h_budget = min(iters, h_iters)
    out = {
        "f": plan(iters, min(RANSAC_CHUNK, iters), 8),
        "h": plan(h_budget, min(RANSAC_CHUNK, h_budget), 4),
        "e": plan(iters, min(RANSAC_CHUNK, iters), 8),
    }
    if five_point:
        out["e5"] = plan(iters, min(five_point_chunk, iters), 5, start=1)
    return out


def draw_uniforms(n_pairs: int, generator: Optional[torch.Generator] = None, *,
                  device=None, iters: int = 1024, h_iters: int = 256,
                  five_point: bool = True, five_point_chunk: int = 16) -> RansacUniforms:
    """Every uniform a batch of ``n_pairs`` may use, drawn on the CPU from
    ``generator`` and moved to ``device`` in one copy: the card and the CPU
    draw the same samples."""
    plan = chunk_plan(iters, h_iters, five_point, five_point_chunk)
    sizes = {k: n_pairs * n * c * m for k, (n, c, m, _) in plan.items()}
    flat = torch.rand(sum(sizes.values()), generator=generator)
    flat = flat.to(device) if device is not None else flat
    parts = dict(zip(sizes, torch.split(flat, list(sizes.values()))))
    streams = {k: parts[k].view(n_pairs, *plan[k][:3]) for k in plan}
    return RansacUniforms(f=streams["f"], h=streams["h"], e=streams["e"],
                          e5=streams.get("e5"))


def _sample_minimal(u: torch.Tensor, sample_size: int, num_valid: torch.Tensor,
                    k_max: int) -> torch.Tensor:
    """Index sets (..., C, sample_size) in [0, num_valid) from uniforms u
    (..., C, sample_size) and counts num_valid (...), without replacement
    (Floyd shifting: draw from the remaining range, then shift past the
    values already chosen, in ascending order)."""
    n = torch.clamp(num_valid, min=sample_size).to(torch.int32)[..., None]
    cols = []
    for t in range(sample_size):
        r = torch.floor(u[..., t] * torch.clamp(n - t, min=1).to(torch.float32))
        r = torch.minimum(r.to(torch.int32), n - t - 1)
        if t > 0:
            prev = torch.sort(torch.stack(cols, dim=-1), dim=-1).values
            for s in range(t):
                r = r + (r >= prev[..., s]).to(torch.int32)
        cols.append(r)
    return torch.clamp(torch.stack(cols, dim=-1), 0, k_max - 1)


def _int_pow(x: torch.Tensor, y: int) -> torch.Tensor:
    """x ** y by binary powering, in the reference's order of products."""
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    return acc


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (P, K, ...) gathered at idx (P, ...) along K."""
    lanes = torch.arange(x.shape[0], device=x.device)
    return x[lanes.view(-1, *([1] * (idx.dim() - 1))), idx]


def _ransac_loop(run_chunk, uniforms, num_valid, iters, sample_size, confidence,
                 init_it, init_cnt, init_model, chunks: Optional[Counter], stream: str):
    """The adaptive hypothesis loop of every lane of a batch.

    ``run_chunk(u) -> (best model (P, 3, 3), its inlier count (P,))`` of one
    chunk; returns each lane's best model and count."""
    chunk = uniforms.shape[2]
    log1mc = math.log(max(1e-12, 1.0 - confidence))
    it_done = torch.full_like(num_valid, init_it)
    best_cnt, best_model = init_cnt, init_model
    for step in range(uniforms.shape[1] + 1):
        ratio = best_cnt.float() / torch.clamp(num_valid, min=1).float()
        p_good = torch.clamp(_int_pow(ratio, sample_size), 1e-9, 1.0 - 1e-9)
        required = log1mc / torch.log1p(-p_good)
        running = ((it_done < iters) & (it_done.float() < required)
                   & (num_valid >= sample_size))
        if not bool(running.any()):
            break
        m, c = run_chunk(uniforms[:, step])
        better = running & (c > best_cnt)
        it_done = torch.where(running, it_done + chunk, it_done)
        best_cnt = torch.where(running, torch.maximum(c, best_cnt), best_cnt)
        best_model = torch.where(better[:, None, None], m, best_model)
        if chunks is not None:
            chunks[stream] += 1
    return best_model, best_cnt


def _refit(refit_fn, err_fn, pts1, pts2, mask, best_model, sample_size, thresh):
    """One weighted refit on the best model's inliers; keep whichever of
    refit and best hypothesis has more inliers."""
    t = thresh[:, None]
    best_inl = (err_fn(best_model[:, None], pts1[:, None], pts2[:, None])[:, 0] <= t) & mask
    w = best_inl.float()
    enough = torch.sum(w, dim=-1) >= sample_size
    refit = refit_fn(pts1, pts2, w)
    model = torch.where(enough[:, None, None], refit, best_model)
    final_inl = (err_fn(model[:, None], pts1[:, None], pts2[:, None])[:, 0] <= t) & mask
    use_refit = torch.sum(final_inl, -1) >= torch.sum(best_inl, -1)
    model = torch.where(use_refit[:, None, None], model, best_model)
    final_inl = torch.where(use_refit[:, None], final_inl, best_inl)
    return model, final_inl, torch.sum(final_inl, -1).to(torch.int32)


def _ransac(fit_fn, refit_fn, err_fn, pts1, pts2, mask, uniforms, iters, sample_size,
            thresh, confidence, seed=None, chunks=None, stream=""):
    """Batched RANSAC with adaptive early exit; returns (model (P, 3, 3),
    inlier_mask (P, K), num_inliers (P,)).

    ``fit_fn(p1s, p2s) -> (models (P, C, S, 3, 3), valid (P, C, S) or
    None)``: S candidates per sample (the 5-point solver's up to 20, or 1),
    each scored as a hypothesis; ``refit_fn`` refits the winner on its
    inliers.  ``seed = (model, count)`` from a cheaper solver starts the
    loop with one hypothesis done: a lane whose seed already meets the
    confidence criterion runs no chunk."""
    num_valid = torch.sum(mask, dim=-1, dtype=torch.int32)
    if seed is None:
        eye = torch.eye(3, dtype=pts1.dtype, device=pts1.device)
        seed, done = (eye.expand(pts1.shape[0], 3, 3), torch.zeros_like(num_valid)), 0
    else:
        done = 1

    def run_chunk(u):
        return multi_chunk(fit_fn, err_fn, pts1, pts2, mask, num_valid, u,
                           sample_size, thresh)

    best_model, _ = _ransac_loop(
        run_chunk, uniforms, num_valid, iters, sample_size, confidence, done,
        seed[1].to(torch.int32), seed[0], chunks, stream)
    return _refit(refit_fn, err_fn, pts1, pts2, mask, best_model, sample_size, thresh)


def _one_model(fit):
    """A single-model fit as a fit of one candidate per sample."""
    return lambda p1, p2: (fit(p1, p2)[..., None, :, :], None)


def multi_chunk(fit_fn, err_fn, pts1, pts2, mask, num_valid, u, sample_size, thresh):
    """One chunk of the loop for every lane: samples from uniforms u (P, C,
    sample_size), all their candidates fitted and scored; returns each
    lane's best candidate (P, 3, 3) and its inlier count."""
    idx = _sample_minimal(u, sample_size, num_valid, pts1.shape[1])
    models, valid = fit_fn(_take(pts1, idx), _take(pts2, idx))
    flat = models.reshape(models.shape[0], -1, 3, 3)  # (P, C * S, 3, 3)
    errs = err_fn(flat, pts1[:, None], pts2[:, None])
    counts = torch.sum((errs <= thresh[:, None, None]) & mask[:, None], -1)
    if valid is not None:
        counts = counts * valid.reshape(counts.shape).to(counts.dtype)
    b = torch.argmax(counts, dim=-1)
    lanes = torch.arange(pts1.shape[0], device=pts1.device)
    return flat[lanes, b], counts[lanes, b].to(torch.int32)


def estimate_two_view_batched(
    pts1: torch.Tensor,  # (P, K, 2) pixel coords, valid entries first
    pts2: torch.Tensor,  # (P, K, 2)
    mask: torch.Tensor,  # (P, K) bool
    K1: torch.Tensor,  # (P, 3, 3) intrinsics of image 1
    K2: torch.Tensor,  # (P, 3, 3)
    calibrated: torch.Tensor,  # (P,) bool: both cameras have a prior focal
    uniforms: RansacUniforms,
    *,
    iters: int = 1024,
    max_error_px: float = 4.0,
    min_num_inliers: int = 15,
    max_h_ratio: float = MAX_H_INLIER_RATIO,
    confidence: float = 0.999,
    five_point: bool = True,
    h_iters: int = 256,
    five_point_chunk: int = 16,
    chunks: Optional[Counter] = None,
) -> TwoViewResult:
    """COLMAP-style two-view geometry of each pair of a batch: estimate E
    (calibrated pairs), F and H, arbitrate the configuration (CALIBRATED /
    UNCALIBRATED / PLANAR_OR_PANORAMIC / DEGENERATE) and return the winning
    inlier set.

    ``uniforms`` comes from :func:`draw_uniforms` with the same ``iters``,
    ``h_iters``, ``five_point`` and ``five_point_chunk``.  ``chunks``, if
    given, counts the chunks each loop ran (streams "f", "h", "e", "e5").
    """
    if five_point != (uniforms.e5 is not None):
        raise ValueError("uniforms were drawn for another essential solver")
    with exact_f32_matmuls():
        return _estimate(
            pts1, pts2, mask.bool(), K1, K2, calibrated.bool(), uniforms, iters=iters,
            max_error_px=max_error_px, min_num_inliers=min_num_inliers,
            max_h_ratio=max_h_ratio, confidence=confidence, five_point=five_point,
            h_iters=h_iters, chunks=chunks)


def _estimate(pts1, pts2, mask, K1, K2, calibrated, uniforms, *, iters, max_error_px,
              min_num_inliers, max_h_ratio, confidence, five_point, h_iters, chunks):
    P = pts1.shape[0]
    thresh_sq = torch.full((P,), max_error_px**2, dtype=torch.float32, device=pts1.device)

    F, f_inl, f_cnt = _ransac(
        _one_model(geom.fit_fundamental), geom.fit_fundamental, geom.sampson_error,
        pts1, pts2, mask, uniforms.f, iters, 8, thresh_sq, confidence,
        chunks=chunks, stream="f")
    # H only arbitrates PLANAR_OR_PANORAMIC, so it gets the smaller budget
    # (on non-planar pairs its criterion never converges).
    H, h_inl, h_cnt = _ransac(
        _one_model(geom.fit_homography), geom.fit_homography, geom.homography_error,
        pts1, pts2, mask, uniforms.h, min(iters, h_iters), 4, thresh_sq, confidence,
        chunks=chunks, stream="h")

    # Essential RANSAC on normalized coordinates; the pixel threshold is
    # mapped by the mean focal length, as COLMAP does.
    def norm_pts(K, pts):
        c = torch.stack([K[:, 0, 2], K[:, 1, 2]], dim=-1)[:, None]
        f = torch.stack([K[:, 0, 0], K[:, 1, 1]], dim=-1)[:, None]
        return (pts - c) / f

    p1n = norm_pts(K1, pts1)
    p2n = norm_pts(K2, pts2)
    focal_mean = (K1[:, 0, 0] + K1[:, 1, 1] + K2[:, 0, 0] + K2[:, 1, 1]) / 4.0
    thresh_sq_n = thresh_sq / torch.clamp(focal_mean * focal_mean, min=1e-12)
    E_direct, e_inl, e_cnt = _ransac(
        _one_model(geom.fit_essential), geom.fit_essential, geom.sampson_error,
        p1n, p2n, mask, uniforms.e, iters, 8, thresh_sq_n, confidence,
        chunks=chunks, stream="e")
    if five_point:
        E_direct, e_inl, e_cnt = _ransac(
            fit_essential_5pt, geom.fit_essential, geom.sampson_error, p1n, p2n, mask,
            uniforms.e5, iters, 5, thresh_sq_n, confidence, seed=(E_direct, e_cnt),
            chunks=chunks, stream="e5")

    # --- COLMAP config arbitration ------------------------------------
    e_wins = (calibrated & (e_cnt >= min_num_inliers)
              & (e_cnt.float() >= MIN_E_F_INLIER_RATIO * f_cnt.float()))
    epi_inl = torch.where(e_wins[:, None], e_inl, f_inl)
    epi_cnt = torch.where(e_wins, e_cnt, f_cnt)
    planar = h_cnt.float() >= max_h_ratio * epi_cnt.float()
    use_h = planar & (h_cnt > epi_cnt)
    inlier_mask = torch.where(use_h[:, None], h_inl, epi_inl)
    num_inliers = torch.where(use_h, h_cnt, epi_cnt)
    config = torch.where(
        num_inliers < min_num_inliers,
        TWO_VIEW_CONFIG["DEGENERATE"],
        torch.where(
            planar,
            TWO_VIEW_CONFIG["PLANAR_OR_PANORAMIC"],
            torch.where(e_wins, TWO_VIEW_CONFIG["CALIBRATED"],
                        TWO_VIEW_CONFIG["UNCALIBRATED"]),
        ),
    ).to(torch.int32)

    # Essential matrix and relative pose: calibrated pairs use the directly
    # estimated E, the others E = K2ᵀ F K1 projected onto the manifold.
    def unit(M):
        n = torch.sqrt(torch.sum(M * M, dim=(-2, -1), keepdim=True))
        return M / torch.clamp(n, min=1e-12)

    E_from_F = geom.project_to_essential(K2.mT @ F @ K1)
    E = unit(torch.where(e_wins[:, None, None], E_direct, E_from_F))
    # F reported consistently with the winning model.
    F_from_E = torch.linalg.inv_ex(K2.mT)[0] @ E_direct @ torch.linalg.inv_ex(K1)[0]
    F_out = unit(torch.where(e_wins[:, None, None], F_from_E, F))

    R, t = geom.recover_pose_from_E(E, p1n, p2n, inlier_mask)
    return TwoViewResult(config=config, inlier_mask=inlier_mask, num_inliers=num_inliers,
                         F=F_out, E=E, H=H, qvec=geom.rotmat_to_qvec(R), tvec=t)


def estimate_two_view(pts1, pts2, mask, K1, K2, calibrated, uniforms: RansacUniforms,
                      **kwargs) -> TwoViewResult:
    """:func:`estimate_two_view_batched` of one pair: inputs and uniforms
    without the batch axis (``draw_uniforms(1, ...)`` drawn for one pair
    is taken as it is), results without it."""
    one = RansacUniforms(*(u if u is None or u.dim() == 4 else u[None] for u in uniforms))
    res = estimate_two_view_batched(
        pts1[None], pts2[None], mask[None], K1[None], K2[None],
        torch.as_tensor(calibrated, device=pts1.device).reshape(1), one, **kwargs)
    return TwoViewResult(*(r[0] for r in res))


def estimate_two_view_batched_packed(flat1, flat2, dest, K1, K2, calibrated,
                                     uniforms: RansacUniforms, *, n_pairs: int,
                                     k_max: int, **kwargs) -> TwoViewResult:
    """:func:`estimate_two_view_batched` on correspondences sent flat: the
    valid ones only, as ``(L, 2)`` buffers, with ``dest[i] = lane * k_max +
    position``; entries with ``dest >= n_pairs * k_max`` pad the buffers
    and are dropped.  The padded (P, k_max) layout and the mask are
    scattered on the device, so the results equal the unpacked call's."""
    size = n_pairs * k_max
    dest = torch.clamp(dest.long(), max=size)  # one spill row for the padding

    def scatter(values, fill):
        out = torch.full((size + 1, *values.shape[1:]), fill, dtype=values.dtype,
                         device=values.device)
        return out.index_copy_(0, dest, values)[:size]

    pts1 = scatter(flat1, 0).reshape(n_pairs, k_max, 2)
    pts2 = scatter(flat2, 0).reshape(n_pairs, k_max, 2)
    mask = scatter(torch.ones_like(dest, dtype=torch.bool), False).reshape(n_pairs, k_max)
    return estimate_two_view_batched(pts1, pts2, mask, K1, K2, calibrated, uniforms,
                                     **kwargs)
