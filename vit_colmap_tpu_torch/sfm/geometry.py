"""Batched multi-view geometry primitives in PyTorch.

The port's copy of ``vit_colmap_tpu/sfm/geometry.py``: every estimator
works on a batch of minimal samples, so that a RANSAC chunk fits all its
hypotheses in one batched solve.  Null spaces come from shifted inverse
iteration with Cholesky solves (not ``eigh``/``svd``): the fixed start
vector and iteration count decide the sign and the last bits of every fit,
as in the reference.

Points are (..., 2) pixel or normalized image coordinates; homogeneous math
is explicit.  Everything is f32 and runs on the tensors' device, except
``undistort_points``, which is host numpy run once per image.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _homog(pts: torch.Tensor) -> torch.Tensor:
    return torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)


def _norm(x: torch.Tensor, dim=-1, keepdim: bool = True) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim))


def normalize_points(pts: torch.Tensor, weights: torch.Tensor):
    """Hartley normalization with per-point weights (masked points weight 0).

    Returns (normalized points, 3x3 transform T) such that x_norm = T @ x.
    """
    w = weights[..., None]
    wsum = torch.clamp(torch.sum(w, dim=-2, keepdim=True), min=1e-8)
    mean = torch.sum(pts * w, dim=-2, keepdim=True) / wsum
    centered = pts - mean
    rms = torch.sqrt(
        torch.sum(torch.sum(centered**2, dim=-1, keepdim=True) * w, dim=-2, keepdim=True)
        / wsum
    )
    scale = math.sqrt(2.0) / torch.clamp(rms, min=1e-8)
    normed = centered * scale
    s = scale[..., 0, 0]
    mx, my = mean[..., 0, 0], mean[..., 0, 1]
    zeros = torch.zeros_like(s)
    ones = torch.ones_like(s)
    T = torch.stack(
        [
            torch.stack([s, zeros, -s * mx], dim=-1),
            torch.stack([zeros, s, -s * my], dim=-1),
            torch.stack([zeros, zeros, ones], dim=-1),
        ],
        dim=-2,
    )
    return normed, T


def _eye(k: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(k, dtype=like.dtype, device=like.device)


def _cholesky_or_nan(A: torch.Tensor):
    """Cholesky factor of each matrix of A, NaN where the factorization
    failed (as ``jnp.linalg.cholesky`` returns), and the failure mask.
    ``cholesky_ex`` reports failure in ``info`` instead of raising, so this
    needs no host sync."""
    L, info = torch.linalg.cholesky_ex(A)
    failed = (info != 0)[..., None, None] | torch.isnan(L).any(-1, keepdim=True).any(
        -2, keepdim=True)
    return torch.where(failed, torch.nan, L), failed


def shifted_cholesky(M: torch.Tensor, shift_rel: float) -> torch.Tensor:
    """Cholesky factor of M + (shift_rel |tr M| + 1e-12) I, retried with the
    shift 1e-3 |tr M| + 1e-8 where the factorization failed (a non-PSD
    matrix from rounding); NaN where the retry fails too."""
    eye = _eye(M.shape[-1], M)
    tr = torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    L, bad = _cholesky_or_nan(M + (shift_rel * tr.abs() + 1e-12) * eye)
    L2, _ = _cholesky_or_nan(M + (1e-3 * tr.abs() + 1e-8) * eye)
    return torch.where(bad, L2, L)


def cholesky_solve_twice(L: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """(L Lᵀ)⁻¹ V for a lower-triangular L and a (..., k, r) right side."""
    y = torch.linalg.solve_triangular(L, V, upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)


def _smallest_eigvec_sym(M: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Smallest-eigenvalue eigenvector of symmetric PSD (..., k, k) via
    shifted inverse iteration with Cholesky solves: the k x k solve
    amplifies the smallest eigendirection by 1/shift per step, so a handful
    of steps recover the nullspace to float32 accuracy."""
    k = M.shape[-1]
    L = shifted_cholesky(M, 1e-7)
    v = torch.full(M.shape[:-1], 1.0 / float(k) ** 0.5, dtype=M.dtype, device=M.device)
    for _ in range(iters):
        v = cholesky_solve_twice(L, v[..., None])[..., 0]
        v = v / torch.clamp(_norm(v), min=1e-30)
    return v


def _nullspace_9(A: torch.Tensor, weights=None) -> torch.Tensor:
    """Approximate right-nullspace of batched A (..., n, 9) -> (..., 9):
    rows normalized first (conditioning), then weighted, then inverse
    iteration on AᵀA."""
    A = A / torch.clamp(_norm(A), min=1e-12)
    if weights is not None:
        A = A * weights[..., None]
    AtA = torch.einsum("...ni,...nj->...ij", A, A)
    return _smallest_eigvec_sym(AtA)


def fit_fundamental(pts1, pts2, weights=None) -> torch.Tensor:
    """Normalized 8-point algorithm, batched.

    pts1/pts2: (..., n>=8, 2); weights: optional (..., n) for weighted fits
    (inlier refits).  Returns (..., 3, 3) rank-2 F in input coordinates,
    unit Frobenius norm.
    """
    w = weights if weights is not None else torch.ones(
        pts1.shape[:-1], dtype=pts1.dtype, device=pts1.device)
    p1n, T1 = normalize_points(pts1, w)
    p2n, T2 = normalize_points(pts2, w)
    x1, y1 = p1n[..., 0], p1n[..., 1]
    x2, y2 = p2n[..., 0], p2n[..., 1]
    ones = torch.ones_like(x1)
    # Epipolar constraint rows: x2ᵀ F x1 = 0.
    A = torch.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, ones], dim=-1
    )
    f = _nullspace_9(A, w)
    F = f.reshape(*f.shape[:-1], 3, 3)
    # Rank 2: subtract the smallest singular component, from the inverse-
    # iteration nullspaces of FᵀF and FFᵀ.
    v3 = _smallest_eigvec_sym(torch.einsum("...ji,...jk->...ik", F, F), iters=6)
    u3 = _smallest_eigvec_sym(torch.einsum("...ij,...kj->...ik", F, F), iters=6)
    s3 = torch.einsum("...i,...ij,...j->...", u3, F, v3)
    F = F - s3[..., None, None] * u3[..., :, None] * v3[..., None, :]
    F = T2.mT @ F @ T1  # denormalize: F = T2ᵀ F_norm T1
    norm = _norm(F.reshape(*F.shape[:-2], 9), keepdim=False)[..., None, None]
    return F / torch.clamp(norm, min=1e-12)


def fit_homography(pts1, pts2, weights=None) -> torch.Tensor:
    """Normalized DLT homography (>=4 points), batched -> (..., 3, 3)."""
    w = weights if weights is not None else torch.ones(
        pts1.shape[:-1], dtype=pts1.dtype, device=pts1.device)
    p1n, T1 = normalize_points(pts1, w)
    p2n, T2 = normalize_points(pts2, w)
    x1, y1 = p1n[..., 0], p1n[..., 1]
    x2, y2 = p2n[..., 0], p2n[..., 1]
    zeros = torch.zeros_like(x1)
    ones = torch.ones_like(x1)
    # Two rows per correspondence.
    r1 = torch.stack([x1, y1, ones, zeros, zeros, zeros, -x2 * x1, -x2 * y1, -x2], dim=-1)
    r2 = torch.stack([zeros, zeros, zeros, x1, y1, ones, -y2 * x1, -y2 * y1, -y2], dim=-1)
    A = torch.cat([r1, r2], dim=-2)
    w2 = torch.cat([w, w], dim=-1)
    h = _nullspace_9(A, w2)
    H = h.reshape(*h.shape[:-1], 3, 3)
    H = torch.linalg.inv_ex(T2)[0] @ H @ T1
    h22 = H[..., 2:3, 2:3]
    return H / torch.where(h22.abs() > 1e-8, h22, 1e-8)


def project_to_essential(F: torch.Tensor, iters: int = 12) -> torch.Tensor:
    """Closest essential matrix (singular values (s, s, 0)) to batched
    near-rank-2 F, without an SVD: nullvector v3 by inverse iteration,
    dominant v1 by deflated power iteration, v2 = v3 x v1."""
    A = torch.einsum("...ji,...jk->...ik", F, F)  # FᵀF
    v3 = _smallest_eigvec_sym(A, iters=8)
    v = torch.tensor([0.577350, 0.577350, 0.577350], dtype=F.dtype,
                     device=F.device).expand(A.shape[:-1])
    v = v - torch.sum(v * v3, -1, keepdim=True) * v3
    for _ in range(iters):
        v = torch.einsum("...ij,...j->...i", A, v)
        v = v - torch.sum(v * v3, -1, keepdim=True) * v3
        v = v / torch.clamp(_norm(v), min=1e-12)
    v1 = v
    v2 = torch.linalg.cross(v3, v1)
    Fv1 = torch.einsum("...ij,...j->...i", F, v1)
    Fv2 = torch.einsum("...ij,...j->...i", F, v2)
    s1 = _norm(Fv1, keepdim=False)
    s2 = _norm(Fv2, keepdim=False)
    u1 = Fv1 / torch.clamp(s1[..., None], min=1e-12)
    u2 = Fv2 - torch.sum(Fv2 * u1, -1, keepdim=True) * u1
    u2 = u2 / torch.clamp(_norm(u2), min=1e-12)
    s = ((s1 + s2) / 2.0)[..., None, None]
    return s * (u1[..., :, None] * v1[..., None, :] + u2[..., :, None] * v2[..., None, :])


def fit_essential(pts1n, pts2n, weights=None) -> torch.Tensor:
    """8-point essential matrix on *normalized* (K⁻¹) coordinates, batched,
    projected onto the essential manifold."""
    return project_to_essential(fit_fundamental(pts1n, pts2n, weights))


def sampson_error(F, pts1, pts2) -> torch.Tensor:
    """Squared Sampson distance for F (..., 3, 3), pts (..., n, 2) -> (..., n)."""
    x1 = _homog(pts1)
    x2 = _homog(pts2)
    Fx1 = torch.einsum("...ij,...nj->...ni", F, x1)
    Ftx2 = torch.einsum("...ji,...nj->...ni", F, x2)
    x2Fx1 = torch.sum(x2 * Fx1, dim=-1)
    denom = Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2
    return x2Fx1**2 / torch.clamp(denom, min=1e-12)


def homography_error(H, pts1, pts2) -> torch.Tensor:
    """Squared forward-transfer error ‖H x1 - x2‖² -> (..., n)."""
    x1 = _homog(pts1)
    Hx1 = torch.einsum("...ij,...nj->...ni", H, x1)
    z = Hx1[..., 2:]
    proj = Hx1[..., :2] / torch.where(z.abs() > 1e-8, z, 1e-8)
    return torch.sum((proj - pts2) ** 2, dim=-1)


def closest_rotation(M: torch.Tensor, iters: int = 60) -> torch.Tensor:
    """Closest proper rotation to batched M (..., 3, 3) in Frobenius norm:
    Davenport's q-method, the dominant eigenvector of a symmetric 4x4 built
    from M by shifted power iteration.  Always returns det = +1."""
    m = M / torch.clamp(_norm(M.flatten(-2), keepdim=False)[..., None, None], min=1e-12)
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    z1, z2, z3 = m12 - m21, m20 - m02, m01 - m10
    K = torch.stack(
        [
            torch.stack([tr, z1, z2, z3], dim=-1),
            torch.stack([z1, 2 * m00 - tr, m01 + m10, m02 + m20], dim=-1),
            torch.stack([z2, m01 + m10, 2 * m11 - tr, m12 + m21], dim=-1),
            torch.stack([z3, m02 + m20, m12 + m21, 2 * m22 - tr], dim=-1),
        ],
        dim=-2,
    )
    # Shift so the largest eigenvalue dominates in magnitude; keep the shift
    # tight (|lambda| <= 2 for unit-Frobenius m) or power iteration crawls.
    Ks = K + 2.1 * _eye(4, K)
    v = torch.full(K.shape[:-1], 0.5, dtype=K.dtype, device=K.device)
    for _ in range(iters):
        v = torch.einsum("...ij,...j->...i", Ks, v)
        v = v / torch.clamp(_norm(v), min=1e-30)
    R = qvec_to_rotmat(v)
    # R(q) or its transpose, whichever is closer to m.
    d1 = torch.sum((R - m) ** 2, dim=(-2, -1))
    d2 = torch.sum((R.mT - m) ** 2, dim=(-2, -1))
    return torch.where((d2 < d1)[..., None, None], R.mT, R)


def _skew(t: torch.Tensor) -> torch.Tensor:
    zeros = torch.zeros_like(t[..., 0])
    return torch.stack(
        [
            torch.stack([zeros, -t[..., 2], t[..., 1]], dim=-1),
            torch.stack([t[..., 2], zeros, -t[..., 0]], dim=-1),
            torch.stack([-t[..., 1], t[..., 0], zeros], dim=-1),
        ],
        dim=-2,
    )


def decompose_essential(E: torch.Tensor):
    """E -> four (R, t) candidates, batched: R (..., 4, 3, 3), t (..., 4, 3).

    t spans the left nullspace of E (inverse iteration on EEᵀ); for each
    ±t, R is the closest rotation to -[t]x E (or [t]x E)."""
    En = E / torch.clamp(_norm(E.flatten(-2), keepdim=False)[..., None, None], min=1e-12)
    EEt = torch.einsum("...ij,...kj->...ik", En, En)
    t = _smallest_eigvec_sym(EEt, iters=8)
    R1 = closest_rotation(-_skew(t) @ En)
    R2 = closest_rotation(_skew(t) @ En)
    Rs = torch.stack([R1, R1, R2, R2], dim=-3)
    ts = torch.stack([t, -t, t, -t], dim=-2)
    return Rs, ts


def triangulate(P1, P2, pts1, pts2) -> torch.Tensor:
    """DLT triangulation, batched: P (..., 3, 4), pts (..., n, 2) -> (..., n, 3)."""

    def rows(P, pts):
        r0 = pts[..., 0:1] * P[..., None, 2, :] - P[..., None, 0, :]
        r1 = pts[..., 1:2] * P[..., None, 2, :] - P[..., None, 1, :]
        return torch.stack([r0, r1], dim=-2)  # (..., n, 2, 4)

    A = torch.cat([rows(P1, pts1), rows(P2, pts2)], dim=-2)  # (..., n, 4, 4)
    A = A / torch.clamp(_norm(A), min=1e-12)
    AtA = torch.einsum("...ki,...kj->...ij", A, A)
    X = _smallest_eigvec_sym(AtA, iters=6)
    w = X[..., 3:]
    return X[..., :3] / torch.where(w.abs() > 1e-10, w, 1e-10)


def cheirality_count(R, t, pts1n, pts2n, mask) -> torch.Tensor:
    """Count points in front of both cameras for pose (R, t), batched."""
    eye = torch.eye(3, 4, dtype=R.dtype, device=R.device).expand(*R.shape[:-2], 3, 4)
    P2 = torch.cat([R, t[..., None]], dim=-1)
    X = triangulate(eye, P2, pts1n, pts2n)
    z1 = X[..., 2]
    X2 = torch.einsum("...ij,...nj->...ni", R, X) + t[..., None, :]
    z2 = X2[..., 2]
    ok = (z1 > 1e-4) & (z2 > 1e-4) & mask
    return torch.sum(ok, dim=-1)


def recover_pose_from_E(E, pts1n, pts2n, mask):
    """Pick the (R, t) with maximal cheirality support -> R (..., 3, 3), t (..., 3)."""
    Rs, ts = decompose_essential(E)  # (..., 4, 3, 3), (..., 4, 3)
    counts = cheirality_count(Rs, ts, pts1n[..., None, :, :], pts2n[..., None, :, :],
                              mask[..., None, :])
    best = torch.argmax(counts, dim=-1)
    R = torch.take_along_dim(Rs, best[..., None, None, None], dim=-3).squeeze(-3)
    t = torch.take_along_dim(ts, best[..., None, None], dim=-2).squeeze(-2)
    return R, t


def rotmat_to_qvec(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> quaternion (w, x, y, z), batched, branch-free
    (the largest of the four diagonal combinations picks the candidate)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    t0 = 1.0 + m00 + m11 + m22  # 4w^2
    t1 = 1.0 + m00 - m11 - m22  # 4x^2
    t2 = 1.0 - m00 + m11 - m22  # 4y^2
    t3 = 1.0 - m00 - m11 + m22  # 4z^2
    c0 = torch.stack([t0, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    c1 = torch.stack([m21 - m12, t1, m01 + m10, m02 + m20], dim=-1)
    c2 = torch.stack([m02 - m20, m01 + m10, t2, m12 + m21], dim=-1)
    c3 = torch.stack([m10 - m01, m02 + m20, m12 + m21, t3], dim=-1)
    cands = torch.stack([c0, c1, c2, c3], dim=-2)  # (..., 4, 4)
    best = torch.argmax(torch.stack([t0, t1, t2, t3], dim=-1), dim=-1)
    q = torch.take_along_dim(cands, best[..., None, None], dim=-2).squeeze(-2)
    q = q / torch.clamp(_norm(q), min=1e-12)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def undistort_points(pts_px, camera: dict):
    """Undistort pixel keypoints for SIMPLE_RADIAL / RADIAL cameras by
    fixed-point inversion of x_d = x_u (1 + k1 r^2 + k2 r^4) (5 iterations
    are exact to float32 for |k| <= 0.5).  Models without distortion
    return the input unchanged.  Host numpy, once per image."""
    p = np.asarray(camera["params"], np.float64)
    model = camera["model"]
    if model == "SIMPLE_RADIAL":
        f, cx, cy = p[0], p[1], p[2]
        k1, k2 = (p[3] if len(p) > 3 else 0.0), 0.0
    elif model == "RADIAL":
        f, cx, cy = p[0], p[1], p[2]
        k1 = p[3] if len(p) > 3 else 0.0
        k2 = p[4] if len(p) > 4 else 0.0
    else:
        return pts_px
    if k1 == 0.0 and k2 == 0.0:
        return pts_px
    pts = np.asarray(pts_px, np.float64)
    xd = (pts - [cx, cy]) / [f, f]
    xu = xd.copy()
    for _ in range(5):
        r2 = (xu**2).sum(-1, keepdims=True)
        xu = xd / (1.0 + k1 * r2 + k2 * r2**2)
    out = xu * [f, f] + [cx, cy]
    return out.astype(np.asarray(pts_px).dtype)


def qvec_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (w, x, y, z) -> rotation matrix, batched."""
    q = q / torch.clamp(_norm(q), min=1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y**2 + z**2), 2 * (x * y - w * z), 2 * (x * z + w * y)], dim=-1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x**2 + z**2), 2 * (y * z - w * x)], dim=-1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x**2 + y**2)], dim=-1),
        ],
        dim=-2,
    )


def _opposite_of_minor(M: np.ndarray, row: int, col: int) -> float:
    x1 = 1 if col == 0 else 0
    x2 = 1 if col == 2 else 2
    y1 = 1 if row == 0 else 0
    y2 = 1 if row == 2 else 2
    return M[y1, x2] * M[y2, x1] - M[y1, x1] * M[y2, x2]


def _signd(x: float) -> int:
    return 1 if x >= 0 else -1


def decompose_homography(H, K):
    """Homography -> candidate motions (Rs, ts, ns), host numpy float64.

    The analytical method of Malis & Vargas, "Deeper understanding of the
    homography decomposition for vision-based control" (INRIA RR-6303,
    2007), as OpenCV's ``decomposeHomographyMat`` implements it, with its
    solutions in its order: (Ra, ta, na), (Ra, -ta, -na), (Rb, tb, nb),
    (Rb, -tb, -nb), or one motion (H itself, t = n = 0) when the normalized
    H is a rotation.  The mapper's init pair keeps the first of equally good
    candidates, so the order matters.  Returns lists of (3, 3) and (3,)
    arrays."""
    H = np.asarray(H, np.float64)
    K = np.asarray(K, np.float64)
    Hn = np.linalg.inv(K) @ H @ K
    # Remove the scale: divide by the middle singular value.
    Hn = Hn * (1.0 / np.linalg.svd(Hn, compute_uv=False)[1])
    S = Hn.T @ Hn - np.eye(3)
    if np.abs(S).max() < 1e-3:  # a pure rotation
        return [Hn], [np.zeros(3)], [np.zeros(3)]

    M00 = _opposite_of_minor(S, 0, 0)
    M11 = _opposite_of_minor(S, 1, 1)
    M22 = _opposite_of_minor(S, 2, 2)
    rtM00, rtM11, rtM22 = np.sqrt(M00), np.sqrt(M11), np.sqrt(M22)
    e12 = _signd(_opposite_of_minor(S, 1, 2))
    e02 = _signd(_opposite_of_minor(S, 0, 2))
    e01 = _signd(_opposite_of_minor(S, 0, 1))
    nS = np.abs(np.diag(S))
    # The largest |S_ii| (the first of equals, by OpenCV's comparisons).
    if nS[0] < nS[1]:
        indx = 2 if nS[1] < nS[2] else 1
    else:
        indx = 2 if nS[0] < nS[2] else 0
    if indx == 0:
        npa = np.array([S[0, 0], S[0, 1] + rtM22, S[0, 2] + e12 * rtM11])
        npb = np.array([S[0, 0], S[0, 1] - rtM22, S[0, 2] - e12 * rtM11])
    elif indx == 1:
        npa = np.array([S[0, 1] + rtM22, S[1, 1], S[1, 2] - e02 * rtM00])
        npb = np.array([S[0, 1] - rtM22, S[1, 1], S[1, 2] + e02 * rtM00])
    else:
        npa = np.array([S[0, 2] + e01 * rtM11, S[1, 2] + rtM00, S[2, 2]])
        npb = np.array([S[0, 2] - e01 * rtM11, S[1, 2] - rtM00, S[2, 2]])

    trace_s = S[0, 0] + S[1, 1] + S[2, 2]
    # OpenCV takes this square root in single precision (sqrtf).
    v = 2.0 * float(np.sqrt(np.float32(1.0 + trace_s - M00 - M11 - M22)))
    esii = _signd(S[indx, indx])
    r = np.sqrt(2.0 + trace_s + v)
    n_t = np.sqrt(2.0 + trace_s - v)
    na = npa / np.linalg.norm(npa)
    nb = npb / np.linalg.norm(npb)
    half_nt = 0.5 * n_t
    esii_t_r = esii * r
    ta_star = half_nt * (esii_t_r * nb - n_t * na)
    tb_star = half_nt * (esii_t_r * na - n_t * nb)

    def rotation(t_star, n):  # R = H (I - (2 / v) t* nᵀ), det +1
        R = Hn @ (np.eye(3) - (2.0 / v) * np.outer(t_star, n))
        return -R if np.linalg.det(R) < 0 else R

    Ra, Rb = rotation(ta_star, na), rotation(tb_star, nb)
    ta, tb = Ra @ ta_star, Rb @ tb_star
    return [Ra, Ra, Rb, Rb], [ta, -ta, tb, -tb], [na, -na, nb, -nb]
