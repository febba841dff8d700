"""Bundle adjustment in PyTorch: Levenberg-Marquardt on the tensors' device.

The port's copy of ``vit_colmap_tpu/sfm/bundle.py``, with the same
parameters, residuals, solvers and step rule:

* parameters = camera poses (axis-angle + translation, 6 per image), shared
  per-camera log-focal scales and radial distortion (k1, k2), and 3D points,
  flattened into one vector,
* residuals = Huber-weighted pixel reprojection errors over the observation
  table (image_idx, point_idx, xy, valid),
* per-observation 2 x 12 Jacobians come from ``torch.func.jacfwd`` under
  ``torch.func.vmap``, taken with respect to the axis-angle vector itself
  (the update is additive, ``x + s * dx``), as the reference's vmapped
  ``jax.jacfwd``,
* ``solver="schur"`` eliminates the points with batched closed-form 3x3
  inverses and solves the dense reduced camera system with one
  ``torch.linalg.solve_ex``; ``solver="cg"`` runs Jacobi-preconditioned
  conjugate gradients with JAX's stopping rule,
* the step is accepted from one batched evaluation of five step scales.

The LM loop is a host loop with one device-to-host sync per iteration (its
early exit); the CG loop runs a fixed number of steps with the converged
state frozen, so it needs no sync.  Segment sums sort their ids once per
call and reduce each segment in a fixed order (``_SegmentSums``), so two
runs on the card give the same bits, as ``jax.ops.segment_sum`` does
(``index_add_`` would add with float atomics there).  Every product runs
inside ``device.exact_f32_matmuls`` (no TF32).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.func import jacfwd, vmap

from vit_colmap_tpu_torch.device import exact_f32_matmuls


def axis_angle_to_matrix(aa: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) -> (..., 3, 3).

    Differentiable at theta = 0: the angle is sqrt(max(|aa|^2, eps)), so the
    Jacobian stays finite at the identity pose (the gauge camera)."""
    sq = torch.sum(aa * aa, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(sq, min=1e-24))
    k = aa / theta
    kx, ky, kz = k[..., 0], k[..., 1], k[..., 2]
    zeros = torch.zeros_like(kx)
    Km = torch.stack(
        [
            torch.stack([zeros, -kz, ky], dim=-1),
            torch.stack([kz, zeros, -kx], dim=-1),
            torch.stack([-ky, kx, zeros], dim=-1),
        ],
        dim=-2,
    )
    th = theta[..., None]
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device).expand(Km.shape)
    R = eye + torch.sin(th) * Km + (1 - torch.cos(th)) * (Km @ Km)
    # First-order fallback for tiny angles (accuracy, not safety).
    R_small = eye + Km * th
    return torch.where(th < 1e-6, R_small, R)


def matrix_to_axis_angle(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 3). Safe for angles < pi - eps."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos = torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0)
    theta = torch.arccos(cos)
    v = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    s = 2.0 * torch.sin(theta)
    axis = v / torch.where(s.abs() < 1e-8, 1.0, s)[..., None]
    return axis * theta[..., None]


class BAProblem(NamedTuple):
    """Bundle-adjustment problem, all tensors on one device.

    cam_params: (n_img, 6) axis-angle + t.  focal_log: (n_cam,) shared
    per-camera log focal scale (effective f = K_f * exp(s); frozen unless
    ``refine_focal_mask`` allows it).  points: (n_pts, 3).
    obs_*: (n_obs,) observation table; obs_valid masks padding.
    K: (n_img, 3, 3); cam_of_img: (n_img,) image -> camera index;
    fixed_cam_mask: (n_img,) poses held constant (gauge fixing);
    refine_focal_mask: (n_cam,).  dist: (n_cam, 2) [k1, k2] applied to
    normalized coordinates (obs_xy are then raw, distorted pixels); None
    means zeros.  refine_dist_mask: (n_cam, 2); None means all frozen.
    """

    cam_params: torch.Tensor
    focal_log: torch.Tensor
    points: torch.Tensor
    obs_cam: torch.Tensor  # int64 (n_obs,) image index
    obs_point: torch.Tensor  # int64 (n_obs,)
    obs_xy: torch.Tensor  # (n_obs, 2) pixels
    obs_valid: torch.Tensor  # bool (n_obs,)
    K: torch.Tensor
    cam_of_img: torch.Tensor  # int64 (n_img,)
    fixed_cam_mask: torch.Tensor
    refine_focal_mask: torch.Tensor  # (n_cam,) bool
    dist: Optional[torch.Tensor] = None
    refine_dist_mask: Optional[torch.Tensor] = None


def _huber_weight(norm: torch.Tensor, huber_delta: float) -> torch.Tensor:
    return torch.where(
        norm > huber_delta,
        torch.sqrt(huber_delta / torch.clamp(norm, min=1e-8)),
        1.0,
    )


def _residuals(cam_params, focal_log, dist, points, problem: BAProblem, huber_delta):
    """(n_obs, 2) Huber-scaled reprojection residuals."""
    cams = cam_params[problem.obs_cam]  # (n_obs, 6)
    X = points[problem.obs_point]  # (n_obs, 3)
    R = axis_angle_to_matrix(cams[:, :3])
    t = cams[:, 3:6]
    obs_camid = problem.cam_of_img[problem.obs_cam]
    fscale = torch.exp(focal_log[obs_camid])
    Xc = torch.einsum("nij,nj->ni", R, X) + t
    z = torch.where(Xc[:, 2:].abs() > 1e-8, Xc[:, 2:], 1e-8)
    xn = Xc[:, :2] / z
    kk = dist[obs_camid]  # (n_obs, 2)
    r2 = torch.sum(xn * xn, dim=-1, keepdim=True)
    xn = xn * (1.0 + kk[:, 0:1] * r2 + kk[:, 1:2] * r2 * r2)
    Kobs = problem.K[problem.obs_cam]
    u = xn[:, 0] * Kobs[:, 0, 0] * fscale + Kobs[:, 0, 2]
    v = xn[:, 1] * Kobs[:, 1, 1] * fscale + Kobs[:, 1, 2]
    r = torch.stack([u, v], dim=-1) - problem.obs_xy
    # Huber reweighting (IRLS): the weight is a constant per linearization.
    norm = torch.linalg.vector_norm(r, dim=-1, keepdim=True)
    r = r * _huber_weight(norm, huber_delta).detach()
    return torch.where(problem.obs_valid[:, None], r, 0.0)


def _one_obs(detach_weight: bool, huber_delta: float):
    """The residual of one observation as a function of its 12 parameters
    [cam 6 | focal_log 1 | k1 k2 | point 3], returned twice (value and
    auxiliary output) for ``jacfwd(..., has_aux=True)``."""

    def r(cp, xy, Kmat, valid):
        c, f, k12, p = cp[:6], cp[6], cp[7:9], cp[9:]
        R = axis_angle_to_matrix(c[:3])
        Xc = R @ p + c[3:6]
        fs = torch.exp(f)
        z = torch.where(Xc[2].abs() > 1e-8, Xc[2], 1e-8)
        xn = Xc[:2] / z
        r2 = torch.sum(xn * xn)
        xn = xn * (1.0 + k12[0] * r2 + k12[1] * r2 * r2)
        u = xn[0] * Kmat[0, 0] * fs + Kmat[0, 2]
        v = xn[1] * Kmat[1, 1] * fs + Kmat[1, 2]
        res = torch.stack([u, v]) - xy
        w = _huber_weight(torch.linalg.vector_norm(res), huber_delta)
        if detach_weight:
            w = w.detach()
        out = res * w * valid
        return out, out

    return r


def _per_obs_jacobians(cam_params, focal_log, dist, points, problem, huber_delta,
                       detach_weight: bool):
    obs_camid = problem.cam_of_img[problem.obs_cam]
    cp = torch.cat(
        [
            cam_params[problem.obs_cam],
            focal_log[obs_camid][:, None],
            dist[obs_camid],
            points[problem.obs_point],
        ],
        dim=1,
    )  # (n_obs, 12)
    fn = jacfwd(_one_obs(detach_weight, huber_delta), has_aux=True)
    return vmap(fn)(cp, problem.obs_xy, problem.K[problem.obs_cam],
                    problem.obs_valid.to(cp.dtype))  # (n_obs, 2, 12), (n_obs, 2)


class _SegmentSums:
    """Segment sums over ids that stay fixed for a bundle-adjustment call,
    in the same order on every run and device.

    The first sum under a key sorts its ids (stable, so each segment keeps
    the order of its rows) and finds the segments' lengths without a host
    sync; every sum is then a gather and one segmented reduction.
    ``index_add_`` would add with float atomics on the card, in an order
    that changes from run to run."""

    def __init__(self):
        self._index: dict = {}

    def __call__(self, key: str, data: torch.Tensor, ids, n: int) -> torch.Tensor:
        """Sum the rows of ``data`` into ``n`` segments; ``ids`` (a tensor, or
        a function giving it, called only on the key's first use) holds each
        row's segment."""
        if key not in self._index:
            flat = (ids() if callable(ids) else ids).reshape(-1)
            sorted_ids, perm = torch.sort(flat, stable=True)
            bounds = torch.searchsorted(
                sorted_ids, torch.arange(n + 1, device=flat.device, dtype=flat.dtype))
            self._index[key] = (perm, bounds[1:] - bounds[:-1])
        perm, lengths = self._index[key]
        return torch.segment_reduce(data[perm], "sum", lengths=lengths, axis=0,
                                    unsafe=True)


def _jtj_diag(cam_params, focal_log, dist, points, problem: BAProblem, huber_delta,
              seg: Optional[_SegmentSums] = None):
    """Exact diag(JᵀJ) from per-observation Jacobians and segment sums.

    As in the reference, the Huber weight is differentiated here (not
    detached): this diagonal only damps and preconditions the CG path."""
    seg = seg or _SegmentSums()
    n_img, n_cam, n_pts = cam_params.shape[0], focal_log.shape[0], points.shape[0]
    J, _ = _per_obs_jacobians(cam_params, focal_log, dist, points, problem,
                              huber_delta, detach_weight=False)
    sq = torch.sum(J * J, dim=1)  # (n_obs, 12)

    def obs_focal():
        return problem.cam_of_img[problem.obs_cam]

    cam_diag = seg("cam", sq[:, :6], problem.obs_cam, n_img)
    focal_diag = seg("focal", sq[:, 6], obs_focal, n_cam)
    dist_diag = seg("focal", sq[:, 7:9], obs_focal, n_cam)
    pt_diag = seg("point", sq[:, 9:], problem.obs_point, n_pts)
    return torch.cat([cam_diag.reshape(-1), focal_diag, dist_diag.reshape(-1),
                      pt_diag.reshape(-1)])


def _obs_jacobians(cam_params, focal_log, dist, points, problem: BAProblem, huber_delta):
    """Per-observation Gauss-Newton rows: J (n_obs, 2, 12) and weighted
    residual r (n_obs, 2).  Column layout per row: [cam 6 | focal_log 1 |
    k1 k2 | point 3]; the Huber weight is detached, so J is the Jacobian of
    the model ``_residuals`` linearizes."""
    return _per_obs_jacobians(cam_params, focal_log, dist, points, problem,
                              huber_delta, detach_weight=True)


def _inv3x3_sym(A: torch.Tensor) -> torch.Tensor:
    """Batched closed-form inverse of symmetric (n, 3, 3) matrices."""
    a, b, c = A[:, 0, 0], A[:, 0, 1], A[:, 0, 2]
    d, e, f = A[:, 1, 1], A[:, 1, 2], A[:, 2, 2]
    co00 = d * f - e * e
    co01 = c * e - b * f
    co02 = b * e - c * d
    co11 = a * f - c * c
    co12 = b * c - a * e
    co22 = a * d - b * b
    det = a * co00 + b * co01 + c * co02
    inv_det = 1.0 / torch.where(det.abs() > 1e-12, det, 1e-12)
    row0 = torch.stack([co00, co01, co02], dim=-1)
    row1 = torch.stack([co01, co11, co12], dim=-1)
    row2 = torch.stack([co02, co12, co22], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2) * inv_det[:, None, None]


def _camera_columns(problem: BAProblem, n_img: int) -> torch.Tensor:
    """(n_obs, 9) columns of each observation's camera-side parameters in
    the reduced system [cam 6*n_img | (focal, k1, k2) per camera]."""
    ar = torch.arange(6, device=problem.obs_cam.device)
    cam_cols = problem.obs_cam[:, None] * 6 + ar[None, :]
    obs_camid = problem.cam_of_img[problem.obs_cam]
    shared_cols = 6 * n_img + obs_camid[:, None] * 3 + ar[None, :3]
    return torch.cat([cam_cols, shared_cols], dim=1)


def _schur_step(x, lam, unpack, problem: BAProblem, huber_delta, col_free, free_mask,
                n_img: int, n_cam: int, n_pts: int,
                seg: Optional[_SegmentSums] = None) -> torch.Tensor:
    """One damped Gauss-Newton step via the point-eliminating Schur
    complement: points are eliminated with batched closed-form 3x3 inverses,
    the reduced camera system (M = 6*n_img + 3*n_cam) is assembled densely
    with segment sums and solved with one dense factorization."""
    seg = seg or _SegmentSums()
    M = 6 * n_img + 3 * n_cam
    cam, focal, dist, pts = unpack(x)
    J, r = _obs_jacobians(cam, focal, dist, pts, problem, huber_delta)
    idx_c = _camera_columns(problem, n_img)  # (n_obs, 9)

    A = J[:, :, :9] * col_free[idx_c][:, None, :]  # fixed params: zero columns
    B = J[:, :, 9:12]
    AtA = torch.einsum("odi,odj->oij", A, A)  # (n_obs, 9, 9)
    AtB = torch.einsum("odi,ody->oiy", A, B)  # (n_obs, 9, 3)
    BtB = torch.einsum("odx,ody->oxy", B, B)  # (n_obs, 3, 3)
    Atr = torch.einsum("odi,od->oi", A, r)  # (n_obs, 9)
    Btr = torch.einsum("odx,od->ox", B, r)  # (n_obs, 3)

    Hcc = seg("cc", AtA.reshape(-1), lambda: idx_c[:, :, None] * M + idx_c[:, None, :],
              M * M).reshape(M, M)
    W = seg("w", AtB.reshape(-1, 3), lambda: problem.obs_point[:, None] * M + idx_c,
            n_pts * M).reshape(n_pts, M, 3)
    Hpp = seg("point", BtB, problem.obs_point, n_pts)
    g_c = seg("c", Atr.reshape(-1), idx_c, M)
    g_p = seg("point", Btr, problem.obs_point, n_pts)

    # Marquardt damping (lam * diag) + a floor so empty point blocks stay
    # invertible.
    eye3 = torch.eye(3, dtype=x.dtype, device=x.device)
    Hpp_d = Hpp + lam * eye3 * torch.diagonal(Hpp, dim1=1, dim2=2)[:, None, :] + 1e-8 * eye3
    Hpp_inv = _inv3x3_sym(Hpp_d)
    Hcc_d = Hcc + torch.diag(lam * torch.diagonal(Hcc))

    T = torch.einsum("pmx,pxy->pmy", W, Hpp_inv)  # (n_pts, M, 3)
    S = Hcc_d - torch.einsum("pmy,pny->mn", T, W)
    rhs = -g_c + torch.einsum("pmy,py->m", T, g_p)
    # Fixed camera columns: identity rows, so the solve stays non-singular
    # and their update is exactly zero.
    S = S * (col_free[:, None] * col_free[None, :]) + torch.diag(1.0 - col_free)
    rhs = rhs * col_free
    # jnp.linalg.solve returns inf / NaN for a singular system where
    # torch.linalg.solve raises: NaN here too, so LM rejects the step and
    # raises lam, as the reference does (no host sync: solve_ex).
    dc, info = torch.linalg.solve_ex(S, rhs)
    dc = torch.where(info != 0, torch.nan, dc)
    dp = -torch.einsum("pxy,py->px", Hpp_inv, g_p + torch.einsum("pmx,m->px", W, dc))

    cam_d = dc[: 6 * n_img].reshape(n_img, 6)
    shared_d = dc[6 * n_img:].reshape(n_cam, 3)
    dx = torch.cat([cam_d.reshape(-1), shared_d[:, 0], shared_d[:, 1:3].reshape(-1),
                    dp.reshape(-1)])
    return dx * free_mask


def _param_columns(problem: BAProblem, n_img: int, n_cam: int) -> torch.Tensor:
    """(n_obs, 12) positions of each observation's parameters in the packed
    vector [cam | focal | dist | points]."""
    o_f = n_img * 6
    o_d = o_f + n_cam
    o_p = o_d + n_cam * 2
    dev = problem.obs_cam.device
    obs_camid = problem.cam_of_img[problem.obs_cam]
    return torch.cat(
        [
            problem.obs_cam[:, None] * 6 + torch.arange(6, device=dev)[None, :],
            (o_f + obs_camid)[:, None],
            o_d + obs_camid[:, None] * 2 + torch.arange(2, device=dev)[None, :],
            o_p + problem.obs_point[:, None] * 3 + torch.arange(3, device=dev)[None, :],
        ],
        dim=1,
    )


def _cg(matvec, b: torch.Tensor, precond: torch.Tensor, maxiter: int, tol: float = 1e-8):
    """Preconditioned conjugate gradients from x0 = 0 with the stopping rule
    of ``jax.scipy.sparse.linalg.cg``: iterate while ‖r‖² > tol²‖b‖² and
    fewer than ``maxiter`` steps ran.  The loop always runs ``maxiter``
    steps; once the rule stops it, the state is frozen, so the result is
    the reference's without a host sync per step."""
    x = torch.zeros_like(b)
    atol2 = tol * tol * torch.dot(b, b)
    r = b - matvec(x)
    z = precond * r
    p = z
    gamma = torch.dot(r, z)
    for _ in range(maxiter):
        active = torch.dot(r, r) > atol2
        Ap = matvec(p)
        alpha = gamma / torch.dot(p, Ap)
        x_ = x + alpha * p
        r_ = r - alpha * Ap
        z_ = precond * r_
        gamma_ = torch.dot(r_, z_)
        beta_ = gamma_ / gamma
        p_ = z_ + beta_ * p
        x = torch.where(active, x_, x)
        r = torch.where(active, r_, r)
        p = torch.where(active, p_, p)
        gamma = torch.where(active, gamma_, gamma)
    return x


def _cg_step(x, lam, unpack, problem: BAProblem, huber_delta, free_mask, cg_iters: int,
             n_img: int, n_cam: int, seg: Optional[_SegmentSums] = None) -> torch.Tensor:
    """One damped Gauss-Newton step by Jacobi-preconditioned CG on
    (JᵀJ + lam diag) dx = -Jᵀr, with J applied through the per-observation
    Jacobians (gather for J v, scatter-add for Jᵀ u)."""
    seg = seg or _SegmentSums()
    cam, focal, dist, pts = unpack(x)
    J, r = _obs_jacobians(cam, focal, dist, pts, problem, huber_delta)
    diag = torch.clamp(_jtj_diag(cam, focal, dist, pts, problem, huber_delta, seg),
                       min=1e-6)
    cols = _param_columns(problem, n_img, n_cam)

    def jt(u):  # Jᵀ u for u (n_obs, 2)
        return seg("param", torch.einsum("odk,od->ok", J, u).reshape(-1), cols,
                   x.shape[0])

    def matvec(v):
        v = v * free_mask
        jv = torch.einsum("odk,ok->od", J, v[cols])
        return jt(jv) * free_mask + lam * diag * v

    g = jt(r) * free_mask
    precond = 1.0 / (diag * (1.0 + lam))
    return _cg(matvec, -g, precond, cg_iters) * free_mask


STEP_SCALES = (1.0, 0.5, 0.25, 0.1, 0.03)


def bundle_adjust(problem: BAProblem, iters: int = 20, cg_iters: int = 50,
                  huber_delta: float = 3.0, solver: str = "cg",
                  stats: Optional[dict] = None):
    """Run LM on the problem's device; returns (cam_params, focal_log, dist,
    points, mean squared residual).  ``stats``, where given, gains the LM
    iterations run (``lm_iters``) and the host syncs made (``syncs``)."""
    if solver not in ("schur", "cg"):
        raise ValueError(f"unknown solver {solver!r}")
    dev, f32 = problem.cam_params.device, problem.cam_params.dtype
    n_img = problem.cam_params.shape[0]
    n_cam = problem.focal_log.shape[0]
    n_pts = problem.points.shape[0]
    if problem.dist is None:
        problem = problem._replace(dist=torch.zeros((n_cam, 2), dtype=f32, device=dev))
    if problem.refine_dist_mask is None:
        problem = problem._replace(
            refine_dist_mask=torch.zeros((n_cam, 2), dtype=torch.bool, device=dev))

    def pack(cam, focal, dist, pts):
        return torch.cat([cam.reshape(-1), focal, dist.reshape(-1), pts.reshape(-1)])

    o_f = n_img * 6
    o_d = o_f + n_cam
    o_p = o_d + n_cam * 2

    def unpack(x):
        return (x[:o_f].reshape(n_img, 6), x[o_f:o_d], x[o_d:o_p].reshape(n_cam, 2),
                x[o_p:].reshape(n_pts, 3))

    cam_free = (~problem.fixed_cam_mask)[:, None].expand(n_img, 6).to(f32)
    focal_free = problem.refine_focal_mask.to(f32)
    dist_free = problem.refine_dist_mask.to(f32)
    free_mask = pack(cam_free, focal_free, dist_free,
                     torch.ones((n_pts, 3), dtype=f32, device=dev))
    # (M,) free/fixed vector of the reduced (camera-side) parameters.
    col_free = torch.cat([cam_free.reshape(-1),
                          torch.stack([focal_free, dist_free[:, 0], dist_free[:, 1]],
                                      dim=-1).reshape(-1)])

    def cost(x):
        cam, focal, dist, pts = unpack(x)
        r = _residuals(cam, focal, dist, pts, problem, huber_delta).reshape(-1)
        return 0.5 * torch.dot(r, r)

    scales = torch.tensor(STEP_SCALES, dtype=f32, device=dev)
    batched_cost = vmap(lambda s, x, dx: cost(x + s * dx), in_dims=(0, None, None))
    x = pack(problem.cam_params, problem.focal_log, problem.dist, problem.points)
    lam = torch.tensor(1e-4, dtype=f32, device=dev)
    n_iter = 0
    seg = _SegmentSums()  # the ids are the problem's: sorted once per call
    with exact_f32_matmuls():
        while n_iter < iters:
            if solver == "schur":
                dx = _schur_step(x, lam, unpack, problem, huber_delta, col_free,
                                 free_mask, n_img, n_cam, n_pts, seg)
            else:
                dx = _cg_step(x, lam, unpack, problem, huber_delta, free_mask,
                              cg_iters, n_img, n_cam, seg)
            # Backtracking over the step scales in one batched evaluation;
            # argmin takes the first of equal costs.
            costs = batched_cost(scales, x, dx)
            best = torch.argmin(costs)
            c_best = costs.index_select(0, best[None])[0]
            c0 = cost(x)
            improved = c_best < c0
            x = torch.where(improved, x + scales.index_select(0, best[None]) * dx, x)
            lam = torch.where(
                improved & (best == 0),
                torch.clamp(lam * 0.3, min=1e-10),
                torch.where(improved, lam, lam * 10.0),
            )
            # Convergence: relative cost decrease < 1e-6, or a trust region
            # blown up by repeated rejected steps.
            rel_dec = (c0 - torch.minimum(c_best, c0)) / torch.clamp(c0, min=1e-12)
            done = (improved & (rel_dec < 1e-6)) | (lam > 1e8)
            n_iter += 1
            if bool(done):  # the one host sync of the iteration
                break
        cam, focal, dist, pts = unpack(x)
        r = _residuals(cam, focal, dist, pts, problem, huber_delta)
    n_valid = torch.clamp(torch.sum(problem.obs_valid), min=1)
    msr = torch.sum(torch.sum(r * r, dim=-1)) / n_valid
    if stats is not None:
        stats["lm_iters"] = stats.get("lm_iters", 0) + n_iter
        stats["syncs"] = stats.get("syncs", 0) + n_iter
    return cam, focal, dist, pts, msr


# ---------------------------------------------------------------------------
# Packed entry point: the problem in three typed host buffers, the result in
# one vector, so a call makes three host-to-device copies and one back.
# ---------------------------------------------------------------------------


def pack_ba_problem(cam, focal_log, dist, pts, obs_cam, obs_pt, obs_xy, obs_valid, K,
                    cam_of_img, fixed, refine_focal, refine_dist):
    """Host-side packing into (fbuf f32, ibuf i32, bbuf bool) numpy buffers,
    in the layout ``bundle_adjust_packed`` unpacks."""
    fbuf = np.concatenate([
        np.asarray(cam, np.float32).ravel(),
        np.asarray(focal_log, np.float32).ravel(),
        np.asarray(dist, np.float32).ravel(),
        np.asarray(pts, np.float32).ravel(),
        np.asarray(obs_xy, np.float32).ravel(),
        np.asarray(K, np.float32).ravel(),
    ])
    ibuf = np.concatenate([
        np.asarray(obs_cam, np.int32).ravel(),
        np.asarray(obs_pt, np.int32).ravel(),
        np.asarray(cam_of_img, np.int32).ravel(),
    ])
    bbuf = np.concatenate([
        np.asarray(obs_valid, bool).ravel(),
        np.asarray(fixed, bool).ravel(),
        np.asarray(refine_focal, bool).ravel(),
        np.asarray(refine_dist, bool).ravel(),
    ])
    return fbuf, ibuf, bbuf


def unpack_ba_problem(fbuf, ibuf, bbuf, *, n_img: int, n_cam: int, n_pts: int,
                      n_obs: int) -> BAProblem:
    """The ``BAProblem`` that ``pack_ba_problem``'s buffers (tensors, or
    numpy arrays for the CPU) hold, as views of them."""
    fbuf, ibuf, bbuf = (torch.as_tensor(b) for b in (fbuf, ibuf, bbuf))
    ibuf = ibuf.long()
    sizes = [n_img * 6, n_cam, n_cam * 2, n_pts * 3, n_obs * 2, n_img * 9]
    cam, focal, dist, pts, obs_xy, K = torch.split(fbuf[:sum(sizes)], sizes)
    obs_cam, obs_pt, cam_of_img = torch.split(ibuf[:2 * n_obs + n_img],
                                              [n_obs, n_obs, n_img])
    obs_valid, fixed, refine_focal, refine_dist = torch.split(
        bbuf[:n_obs + n_img + 3 * n_cam], [n_obs, n_img, n_cam, 2 * n_cam])
    return BAProblem(
        cam_params=cam.reshape(n_img, 6),
        focal_log=focal,
        points=pts.reshape(n_pts, 3),
        obs_cam=obs_cam,
        obs_point=obs_pt,
        obs_xy=obs_xy.reshape(n_obs, 2),
        obs_valid=obs_valid,
        K=K.reshape(n_img, 3, 3),
        cam_of_img=cam_of_img,
        fixed_cam_mask=fixed,
        refine_focal_mask=refine_focal,
        dist=dist.reshape(n_cam, 2),
        refine_dist_mask=refine_dist.reshape(n_cam, 2),
    )


def bundle_adjust_packed(fbuf, ibuf, bbuf, *, n_img: int, n_cam: int, n_pts: int,
                         n_obs: int, iters: int = 20, cg_iters: int = 50,
                         huber_delta: float = 3.0, solver: str = "cg",
                         stats: Optional[dict] = None) -> torch.Tensor:
    """``bundle_adjust`` over packed buffers (tensors, on the device it
    runs on, or numpy arrays for the CPU); returns one packed vector
    [cam (n_img*6) | focal (n_cam) | dist (n_cam*2) | pts (n_pts*3) | msr]."""
    problem = unpack_ba_problem(fbuf, ibuf, bbuf, n_img=n_img, n_cam=n_cam, n_pts=n_pts,
                                n_obs=n_obs)
    cam_o, focal_o, dist_o, pts_o, msr = bundle_adjust(
        problem, iters=iters, cg_iters=cg_iters, huber_delta=huber_delta,
        solver=solver, stats=stats)
    return torch.cat([cam_o.reshape(-1), focal_o, dist_o.reshape(-1), pts_o.reshape(-1),
                      msr[None]])


def unpack_ba_result(out, n_img: int, n_cam: int, n_pts: int):
    """Split the packed result (a tensor on any device, or numpy) back into
    float64 numpy parts, after one device-to-host copy."""
    if isinstance(out, torch.Tensor):
        out = out.cpu().numpy()
    out = np.asarray(out, np.float64)
    o_f = n_img * 6
    o_d = o_f + n_cam
    o_p = o_d + n_cam * 2
    o_e = o_p + n_pts * 3
    return (
        out[:o_f].reshape(n_img, 6),
        out[o_f:o_d],
        out[o_d:o_p].reshape(n_cam, 2),
        out[o_p:o_e].reshape(n_pts, 3),
        float(out[o_e]),
    )
