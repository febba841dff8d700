"""Absolute pose (PnP) estimation: batched DLT + vectorized RANSAC.

The port's copy of ``vit_colmap_tpu/sfm/pnp.py``.  The mapper registers each
image with :func:`pnp_ransac`: every hypothesis is a 6-point DLT on
K-normalized coordinates, all of them fitted in one batched solve, scored
at once, and the best inlier set refitted.  The sample uniforms are passed
in (the reference draws them from a JAX key), so the card and the CPU, and
a test holding the port against the reference, draw the same samples.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vit_colmap_tpu_torch.device import exact_f32_matmuls
from vit_colmap_tpu_torch.sfm import geometry as geom


def fit_pose_dlt(pts2d: torch.Tensor, pts3d: torch.Tensor, weights=None):
    """DLT absolute pose: x ~ [R|t] X.  pts2d (..., n, 2) K-normalized,
    pts3d (..., n, 3).  Returns (R (..., 3, 3), t (..., 3)).

    The linear P is projected onto SE(3): R by orthogonalization, the
    translation rescaled by the mean singular value, and the sign fixed by
    majority positive depth."""
    w = weights if weights is not None else torch.ones(
        pts2d.shape[:-1], dtype=pts2d.dtype, device=pts2d.device)
    X, Y, Z = pts3d[..., 0], pts3d[..., 1], pts3d[..., 2]
    x, y = pts2d[..., 0], pts2d[..., 1]
    ones = torch.ones_like(X)
    zeros = torch.zeros_like(X)
    r1 = torch.stack(
        [X, Y, Z, ones, zeros, zeros, zeros, zeros, -x * X, -x * Y, -x * Z, -x], dim=-1)
    r2 = torch.stack(
        [zeros, zeros, zeros, zeros, X, Y, Z, ones, -y * X, -y * Y, -y * Z, -y], dim=-1)
    A = torch.cat([r1, r2], dim=-2)  # (..., 2n, 12)
    # Row-normalize for conditioning, then weights; nullspace by inverse
    # iteration.
    A = A / torch.clamp(geom._norm(A), min=1e-12)
    A = A * torch.cat([w, w], dim=-1)[..., None]
    AtA = torch.einsum("...ni,...nj->...ij", A, A)
    p = geom._smallest_eigvec_sym(AtA, iters=8)
    P = p.reshape(*p.shape[:-1], 3, 4)

    # The nullspace is defined up to sign: resolve it by cheirality before
    # orthogonalization (closest_rotation always returns a proper rotation).
    Rm = P[..., :3]
    tm = P[..., 3]
    depth = torch.einsum("...ij,...nj->...ni", Rm, pts3d)[..., 2] + tm[..., None, 2]
    pos = torch.sum((depth > 0) * w, dim=-1)
    neg = torch.sum((depth < 0) * w, dim=-1)
    sgn = torch.where(neg > pos, -1.0, 1.0)
    Rm = Rm * sgn[..., None, None]
    tm = tm * sgn[..., None]

    R = geom.closest_rotation(Rm)
    # Scale: the sum of singular values of Rm equals tr(RᵀRm) at the optimum.
    scale = torch.einsum("...ij,...ij->...", R, Rm) / 3.0
    t = tm / torch.clamp(scale[..., None], min=1e-12)
    return R, t


def reprojection_error_px(R, t, pts3d, pts2d_px, K):
    """Squared pixel reprojection error -> (..., n); infinite behind the
    camera."""
    Xc = torch.einsum("...ij,...nj->...ni", R, pts3d) + t[..., None, :]
    z = torch.where(Xc[..., 2:].abs() > 1e-8, Xc[..., 2:], 1e-8)
    xn = Xc[..., :2] / z
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    cx, cy = K[..., 0, 2], K[..., 1, 2]
    u = xn[..., 0] * fx[..., None] + cx[..., None]
    v = xn[..., 1] * fy[..., None] + cy[..., None]
    err = (u - pts2d_px[..., 0]) ** 2 + (v - pts2d_px[..., 1]) ** 2
    return torch.where(Xc[..., 2] > 1e-6, err, torch.inf)


class PnPResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    inlier_mask: torch.Tensor
    num_inliers: torch.Tensor


def pnp_ransac(pts2d_px: torch.Tensor, pts3d: torch.Tensor, mask: torch.Tensor,
               K: torch.Tensor, uniforms: torch.Tensor,
               max_error_px: float = 8.0) -> PnPResult:
    """RANSAC over ``uniforms.shape[0]`` 6-point hypotheses on the tensors'
    device.  pts2d_px (N, 2) pixels and pts3d (N, 3), valid rows first as
    ``mask`` (N,) says; ``uniforms`` (iters, 6) in [0, 1) pick each
    hypothesis's rows (with replacement, as the reference).  The batched
    products run in full f32 whatever the caller's TF32 flag, as the
    reference's fits are f32."""
    with exact_f32_matmuls():
        n_max = pts2d_px.shape[0]
        num_valid = torch.sum(mask)
        fx, fy = K[0, 0], K[1, 1]
        cx, cy = K[0, 2], K[1, 2]
        pts2d_n = (pts2d_px - torch.stack([cx, cy])) / torch.stack([fx, fy])

        idx = torch.clamp(
            torch.floor(uniforms * torch.clamp(num_valid, min=1).to(uniforms.dtype)).long(),
            0, n_max - 1)
        R, t = fit_pose_dlt(pts2d_n[idx], pts3d[idx])  # (S, 3, 3), (S, 3)
        errs = reprojection_error_px(R, t, pts3d[None], pts2d_px[None], K[None])
        inl = (errs <= max_error_px**2) & mask[None]
        counts = torch.sum(inl, dim=-1)
        best = torch.argmax(counts)
        best_i = best[None]
        R_b, t_b = R.index_select(0, best_i)[0], t.index_select(0, best_i)[0]
        inl_b, count_b = inl.index_select(0, best_i)[0], counts.index_select(0, best_i)[0]
        w = inl_b.to(pts2d_px.dtype)
        enough = torch.sum(w) >= 6
        R_ref, t_ref = fit_pose_dlt(pts2d_n[None], pts3d[None], w[None])
        R_f = torch.where(enough, R_ref[0], R_b)
        t_f = torch.where(enough, t_ref[0], t_b)
        err_f = reprojection_error_px(R_f[None], t_f[None], pts3d[None], pts2d_px[None],
                                      K[None])[0]
        inl_f = (err_f <= max_error_px**2) & mask
        better = torch.sum(inl_f) >= count_b
        R_out = torch.where(better, R_f, R_b)
        t_out = torch.where(better, t_f, t_b)
        inl_out = torch.where(better, inl_f, inl_b)
        return PnPResult(R_out, t_out, inl_out, torch.sum(inl_out).to(torch.int32))


def pnp_ransac_packed(fbuf: torch.Tensor, mask: torch.Tensor, uniforms: torch.Tensor, *,
                      n: int, max_error_px: float = 8.0) -> torch.Tensor:
    """``pnp_ransac`` over one packed float buffer [xy (n*2) | X (n*3) |
    K (9)], with one packed result [R (9) | t (3) | num_inliers (1) |
    inlier_mask (n)], so a registration makes one copy each way."""
    xy = fbuf[: n * 2].reshape(n, 2)
    X = fbuf[n * 2: n * 5].reshape(n, 3)
    K = fbuf[n * 5: n * 5 + 9].reshape(3, 3)
    res = pnp_ransac(xy, X, mask, K, uniforms, max_error_px=max_error_px)
    return torch.cat([
        res.R.reshape(-1),
        res.t,
        res.num_inliers.to(fbuf.dtype)[None],
        res.inlier_mask.to(fbuf.dtype),
    ])
