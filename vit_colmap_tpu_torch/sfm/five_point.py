"""Batched five-point essential-matrix solver (Nister's minimal problem).

The port's copy of ``vit_colmap_tpu/sfm/five_point.py``, with the same
hidden-variable resultant algorithm:

1. the 4-dim right nullspace (X, Y, Z, W) of the 5 x 9 epipolar matrix by
   blocked inverse iteration with Cholesky solves and Gram-Schmidt,
2. E = x X + y Y + z Z + W through the 10 cubic constraints (det E = 0 and
   2 E Eᵀ E - tr(E Eᵀ) E = 0) as a (10 x 10 x 4) tensor M(z): equation x
   (x, y)-monomial x z-power,
3. det M(z), a degree-10 polynomial, from its values at 16 Chebyshev nodes
   (partial-pivot elimination) and a precomputed pseudo-inverse
   Vandermonde,
4. real roots by a sign sweep on a tan-spaced grid and 40 bisection steps,
5. each root's (x, y) from the nullvector of M(z*), and the candidate E
   projected onto the essential manifold.

The reference builds step 2 by symbolic algebra unrolled at trace time,
which XLA fuses into one program; run eagerly that would be some 60,000
launches per chunk.  Here it is tensor algebra instead: with c = (x, y, z,
1) and B = (X, Y, Z, W), E Eᵀ E and tr(E Eᵀ) E are sums over basis triples
(B_a B_bᵀ B_c, tr(B_a B_bᵀ) B_c), and det E is trilinear in the columns,
det[B_a[:, 0], B_b[:, 1], B_c[:, 2]].  So the 10 equations are a few
batched ``einsum``s over the 64 triples, folded into the (10, 10, 4)
layout by one static 0/1 matrix.  It is the same polynomial with a
different rounding.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from vit_colmap_tpu_torch.sfm.geometry import (
    _smallest_eigvec_sym,
    cholesky_solve_twice,
    project_to_essential,
    shifted_cholesky,
)

_ZD = 4  # z-degree slots (degree <= 3)

# The 10 (x, y)-monomials of a cubic: this ordering fixes M(z)'s columns.
_MONOMIALS = [
    (3, 0), (2, 1), (1, 2), (0, 3),  # cubic in (x, y): z-degree 0
    (2, 0), (1, 1), (0, 2),          # quadratic:       z-degree <= 1
    (1, 0), (0, 1),                  # linear:          z-degree <= 2
    (0, 0),                          # constant:        z-degree <= 3
]
_MONO_INDEX = {m: i for i, m in enumerate(_MONOMIALS)}
_IDX_X = _MONO_INDEX[(1, 0)]
_IDX_Y = _MONO_INDEX[(0, 1)]
_IDX_1 = _MONO_INDEX[(0, 0)]
_IDX_X2 = _MONO_INDEX[(2, 0)]
_IDX_XY = _MONO_INDEX[(1, 1)]
_IDX_Y2 = _MONO_INDEX[(0, 2)]


def _triple_fold() -> np.ndarray:
    """(64, 40) 0/1 matrix: basis triple (a, b, c), coefficient c_a c_b c_c
    with c = (x, y, z, 1), -> its (monomial, z-power) cell of M(z)."""
    fold = np.zeros((64, len(_MONOMIALS) * _ZD), np.float32)
    for t, triple in enumerate(itertools.product(range(4), repeat=3)):
        px, py, pz = (triple.count(v) for v in range(3))
        fold[t, _MONO_INDEX[(px, py)] * _ZD + pz] = 1.0
    return fold


_FOLD = _triple_fold()
# Levi-Civita symbol: det[u, v, w] = eps_ijk u_i v_j w_k.
_EPS = np.zeros((3, 3, 3), np.float32)
for _i, _j, _k in itertools.permutations(range(3)):
    _EPS[_i, _j, _k] = np.linalg.det(np.eye(3)[[_i, _j, _k]])


def _constraint_tensor(B: torch.Tensor) -> torch.Tensor:
    """The 10 cubic constraints of E = x B_0 + y B_1 + z B_2 + B_3 as a
    (..., 10, 10, 4) tensor from the basis B (..., 4, 3, 3).

    Axis -3: equation (det E, then the 9 entries of 2 E Eᵀ E - tr(E Eᵀ) E,
    row-major).  Axis -2: (x, y) monomial (``_MONOMIALS`` order).
    Axis -1: z-coefficients, lowest first.
    """
    eps = torch.as_tensor(_EPS, device=B.device, dtype=B.dtype)
    fold = torch.as_tensor(_FOLD, device=B.device, dtype=B.dtype)
    cols = B.unbind(-1)  # 3 x (..., 4, 3): column j of each basis matrix
    det = torch.einsum("ijk,...ai,...bj,...ck->...abc", eps, *cols)
    G = torch.einsum("...aik,...bjk->...abij", B, B)  # B_a B_bᵀ
    GB = torch.einsum("...abik,...ckj->...abcij", G, B)  # B_a B_bᵀ B_c
    tr = torch.diagonal(G, dim1=-2, dim2=-1).sum(-1)  # tr(B_a B_bᵀ)
    trace_eq = 2.0 * GB - tr[..., None, None, None] * B[..., None, None, :, :, :]
    batch = B.shape[:-3]
    T = torch.cat([det.reshape(*batch, 64, 1), trace_eq.reshape(*batch, 64, 9)], dim=-1)
    C = torch.einsum("...te,tm->...em", T, fold)
    return C.reshape(*batch, 10, len(_MONOMIALS), _ZD)


# ---------------------------------------------------------------------------
# Determinant of M(z) -> degree-10 polynomial via static-node interpolation.
# ---------------------------------------------------------------------------

_N_NODES = 16
_DET_DEG = 10
# Static Chebyshev nodes and the pseudo-inverse Vandermonde (f64 -> f32).
_NODES = np.cos((2 * np.arange(_N_NODES) + 1) / (2.0 * _N_NODES) * np.pi)
_VAND = np.stack([_NODES**k for k in range(_DET_DEG + 1)], axis=1)  # 16x11
_VAND_PINV = np.linalg.pinv(_VAND).astype(np.float32)  # 11x16


def _det10(M: torch.Tensor) -> torch.Tensor:
    """Determinant of batched (..., n, n) by partial-pivot Gaussian
    elimination, the pivot row swapped in by index."""
    n = M.shape[-1]
    M = M.clone()
    det = torch.ones(M.shape[:-2], dtype=M.dtype, device=M.device)
    for k in range(n - 1):
        p = torch.argmax(M[..., k:, k].abs(), dim=-1)  # pivot offset
        src = (p + k)[..., None, None].expand(*p.shape, 1, n)
        pivot_row = torch.gather(M, -2, src)
        M.scatter_(-2, src, M[..., k : k + 1, :].clone())
        M[..., k : k + 1, :] = pivot_row
        det = det * torch.where(p > 0, -1.0, 1.0)
        piv = M[..., k, k]
        det = det * piv
        safe = torch.where(piv.abs() > 1e-30, piv, 1e-30)
        factors = M[..., k + 1 :, k] / safe[..., None]
        M[..., k + 1 :, :] -= factors[..., None] * M[..., k : k + 1, :]
    return det * M[..., n - 1, n - 1]


def _det_poly_coeffs(C: torch.Tensor) -> torch.Tensor:
    """(..., 10, 10, 4) constraint tensor -> (..., 11) coefficients of
    det M(z), lowest degree first."""
    nodes = torch.as_tensor(_NODES, dtype=C.dtype, device=C.device)
    zpow = torch.stack([nodes**k for k in range(_ZD)], dim=-1)  # (16, 4)
    Mn = torch.einsum("...eqk,nk->...neq", C, zpow)  # (..., 16, 10, 10)
    dets = _det10(Mn)  # (..., 16)
    vand_pinv = torch.as_tensor(_VAND_PINV, dtype=C.dtype, device=C.device)
    return torch.einsum("cn,...n->...c", vand_pinv, dets)


# ---------------------------------------------------------------------------
# Real roots of a degree-10 polynomial: tan-grid sweep + fixed bisection.
# ---------------------------------------------------------------------------

_N_GRID = 512
_THETA_MAX = 1.55  # |z| <= tan(1.55) ~ 48
_GRID = np.tan(np.linspace(-_THETA_MAX, _THETA_MAX, _N_GRID)).astype(np.float32)
_MAX_ROOTS = 10
_BISECT_ITERS = 40


def _polyval(coeffs: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Evaluate (..., 11) coefficients (lowest first) at z (broadcast), by
    Horner's rule."""
    acc = coeffs[..., -1]
    for k in range(coeffs.shape[-1] - 2, -1, -1):
        acc = torch.addcmul(coeffs[..., k], acc, z)
    return acc


def _real_roots(coeffs: torch.Tensor):
    """(..., 11) -> (roots (..., 10), valid (..., 10)) from sign changes on
    the tan grid and fixed-depth bisection."""
    grid = torch.as_tensor(_GRID, dtype=coeffs.dtype, device=coeffs.device)
    vals = _polyval(coeffs[..., None, :], grid)  # (..., 512)
    s = torch.sign(vals)
    change = (s[..., :-1] * s[..., 1:]) < 0  # (..., 511)
    cells = torch.arange(_N_GRID - 1, dtype=torch.int32, device=coeffs.device)
    pos = torch.where(change, cells, _N_GRID)
    # The first 10 sign-change cells (the reference's top_k on -pos, read
    # back to front); the sentinel cells are equal, so their order does not
    # matter.
    cells = -torch.topk(-pos, _MAX_ROOTS, dim=-1).values.flip(-1)
    valid = cells < _N_GRID
    cells = torch.clamp(cells, max=_N_GRID - 2).long()
    lo = grid[cells]
    hi = grid[cells + 1]
    flo = _polyval(coeffs[..., None, :], lo)
    for _ in range(_BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        fmid = _polyval(coeffs[..., None, :], mid)
        go_left = (flo * fmid) <= 0
        hi = torch.where(go_left, mid, hi)
        lo = torch.where(go_left, lo, mid)
        flo = torch.where(go_left, flo, fmid)
    return 0.5 * (lo + hi), valid


# ---------------------------------------------------------------------------
# Public solver.
# ---------------------------------------------------------------------------


def _nullspace_basis_4(Q: torch.Tensor) -> torch.Tensor:
    """Orthonormal 4-dim right-nullspace basis of (..., 5, 9) -> (..., 9, 4)
    by blocked inverse iteration with Cholesky solves and modified
    Gram-Schmidt."""
    Q = Q / torch.clamp(torch.sqrt(torch.sum(Q * Q, -1, keepdim=True)), min=1e-12)
    A = torch.einsum("...ni,...nj->...ij", Q, Q)  # (..., 9, 9) PSD, rank <= 5
    L = shifted_cholesky(A, 1e-6)
    # Deterministic full-rank start: 4 fixed unit directions.
    V = torch.eye(9, dtype=A.dtype, device=A.device)[:, :4].expand(*A.shape[:-2], 9, 4)
    for _ in range(8):
        V = cholesky_solve_twice(L, V)
        cols = []
        for c in range(4):
            v = V[..., c]
            for u in cols:
                v = v - torch.sum(v * u, dim=-1, keepdim=True) * u
            v = v / torch.clamp(torch.sqrt(torch.sum(v * v, -1, keepdim=True)), min=1e-30)
            cols.append(v)
        V = torch.stack(cols, dim=-1)
    return V


def fit_essential_5pt(pts1n: torch.Tensor, pts2n: torch.Tensor):
    """Minimal 5-point essential solver, batched.

    Args: pts1n, pts2n -- (..., 5, 2) *normalized* (K⁻¹) correspondences.
    Returns: (E (..., 20, 3, 3), valid (..., 20)) candidate essential
    matrices (unit Frobenius norm, on-manifold) with a validity mask.

    Two affine charts of the nullspace are solved, as one batch: w = 1 with
    basis order (X, Y, Z, W) and with (W, Z, Y, X).  The first is
    ill-conditioned in float32 when the true solution's component on W is
    small, and the two have near-disjoint failure sets.
    """
    x1, y1 = pts1n[..., 0], pts1n[..., 1]
    x2, y2 = pts2n[..., 0], pts2n[..., 1]
    one = torch.ones_like(x1)
    # Epipolar rows: p2ᵀ E p1 = 0 with E raveled row-major.
    Q = torch.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, one], dim=-1
    )  # (..., 5, 9)
    V = _nullspace_basis_4(Q)  # (..., 9, 4)
    basis = V.mT.reshape(*V.shape[:-2], 4, 3, 3)
    charts = torch.stack([basis, basis.flip(-3)], dim=-4)  # (..., 2, 4, 3, 3)
    E, valid = _solve_chart(charts)  # (..., 2, 10, 3, 3), (..., 2, 10)
    batch = pts1n.shape[:-2]
    return E.reshape(*batch, 20, 3, 3), valid.reshape(*batch, 20)


def _solve_chart(B: torch.Tensor):
    """Solve the affine chart E = x B_0 + y B_1 + z B_2 + B_3 of each basis
    (..., 4, 3, 3) -> 10 candidates (..., 10, 3, 3) and their validity."""
    C = _constraint_tensor(B)  # (..., 10, 10, 4)
    # Row-normalize each equation (pure conditioning, z-independent).
    rn = torch.sqrt(torch.sum(C * C, dim=(-2, -1), keepdim=True))
    C = C / torch.clamp(rn, min=1e-30)

    coeffs = _det_poly_coeffs(C)  # (..., 11)
    roots, valid = _real_roots(coeffs)  # (..., 10)

    # M(z*) for each root -> nullvector -> (x, y).
    zpow = torch.stack([roots**k for k in range(_ZD)], dim=-1)  # (..., 10, 4)
    Mr = torch.einsum("...eqk,...rk->...req", C, zpow)  # (..., 10, 10, 10)
    m = _smallest_eigvec_sym(torch.einsum("...ne,...nq->...eq", Mr, Mr))

    # x, y from monomial ratios; prefer the constant-normalized read, fall
    # back to degree-2/degree-1 ratios when the constant entry is tiny.
    c0 = m[..., _IDX_1]
    use_c = c0.abs() > 1e-5
    safe_c = torch.where(use_c, c0, 1.0)
    x_c, y_c = m[..., _IDX_X] / safe_c, m[..., _IDX_Y] / safe_c
    xl = m[..., _IDX_X]
    yl = m[..., _IDX_Y]
    safe_x = torch.where(xl.abs() > 1e-12, xl, 1e-12)
    safe_y = torch.where(yl.abs() > 1e-12, yl, 1e-12)
    x_first = xl.abs() > yl.abs()
    x_alt = torch.where(x_first, m[..., _IDX_X2] / safe_x, m[..., _IDX_XY] / safe_y)
    y_alt = torch.where(x_first, m[..., _IDX_XY] / safe_x, m[..., _IDX_Y2] / safe_y)
    x = torch.where(use_c, x_c, x_alt)
    y = torch.where(use_c, y_c, y_alt)

    X, Y, Z, W = (B[..., None, k, :, :] for k in range(4))
    E = (x[..., None, None] * X + y[..., None, None] * Y
         + roots[..., None, None] * Z + W)
    finite = torch.isfinite(E).all(-1).all(-1)
    E = torch.where(finite[..., None, None], E, torch.eye(3, dtype=E.dtype, device=E.device))
    E = project_to_essential(E)
    norm = torch.sqrt(torch.sum(E * E, dim=(-2, -1), keepdim=True))
    return E / torch.clamp(norm, min=1e-12), valid & finite
