"""Kernels 2, 4 and 5: row top-2 matching of descriptor pairs.

Counterparts of ``vit_colmap_tpu/ops/pallas/match_kernel.py``:

* :func:`match_topk2_colmax` (kernel 2, ``pallas_topk2_colmax``): row top-2
  and column argmax in one pass, ``csrc/match_topk2.cu``;
* :func:`match_topk2` (kernel 4, ``pallas_topk2``): row top-2 only, the same
  CUDA body without the column partials;
* :func:`match_topk2_int8` (kernel 5, ``pallas_topk2_int8``): row top-2 of
  the exact cosine of uint8 descriptors from int8 dot products,
  ``csrc/match_topk2_int8.cu``;
* :func:`match_pairs` / :func:`match_pairs_int8` (``pallas_match_pairs`` /
  ``pallas_match_pairs_int8``): the kernels plus the COLMAP filter.

Row top-2 rules, shared by all three: invalid columns read as -2, the
state is seeded at (-2, -2, index 0), the first column reaching the max
wins, and the second is the max over every other column.

Float similarities are fp32 FMA chains in a fixed order over the descriptor
dimension (``s = fma(d1[d], d2[d], s)`` for d = 0..D-1); the int8 epilogue
is separately rounded f32 operations in the reference's order.  The plain
versions repeat both, so kernels and plain versions agree bit for bit and
break near-ties the same way.

The kernels take every descriptor width D that is a multiple of
``WIDTH_STEP`` (128), as the reference's kernels do; they raise
``NotImplementedError`` for other widths on the card.
"""

from __future__ import annotations

import torch

from vit_colmap_tpu_torch.kernels.build import launch

WIDTH_STEP = 128  # the kernels take descriptor widths that are multiples of this
TILE_N = 128  # row tile of kernel 2's column partials


def takes_width(dim: int) -> bool:
    """Whether the kernels take descriptors ``dim`` wide: a multiple of
    WIDTH_STEP."""
    return dim % WIDTH_STEP == 0


def similarity_plain(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """(N, D) x (M, D) -> (N, M) f32, as the sequential fp32 FMA chain.

    Each step is one fused multiply-add: the f32 product is exact in f64 and
    the f64 sum, rounded once more to f32, is the fused result (up to a
    double rounding that needs an exact f32 half-way case)."""
    a = d1.double()
    b = d2.double()
    s = torch.zeros(a.shape[0], b.shape[0], dtype=torch.float32, device=a.device)
    for d in range(a.shape[1]):
        s = torch.addcmul(s.double(), a[:, d, None], b[None, :, d]).float()
    return s


def int8_similarity_plain(a1, a2, s1, s2, inv1, inv2, coef) -> torch.Tensor:
    """(N, D) x (M, D) int8 -> (N, M) f32 cosine, -2 where ``inv2 == 0``.

    ``acc`` is the exact integer dot product (computed in f64, exact for
    these ranges, since CUDA has no integer matmul); every float operation
    after it is rounded on its own, in the reference's order."""
    acc = (a1.double() @ a2.double().T).float()
    dot = coef[0] * acc + coef[1] * (s1[:, None] + s2[None, :]) + coef[2]
    sim = dot * inv1[:, None] * inv2[None, :]
    return torch.where(inv2[None, :] > 0, sim, -2.0)


def _row_top2(sim: torch.Tensor):
    """(N, M) similarities -> (best, second, best_idx) with the kernels'
    seed (-2, -2, 0) and first-column tie rule."""
    top = torch.topk(sim, 2, dim=1).values
    idx = torch.argmax(sim, dim=1)  # the first maximum
    best = top[:, 0].clamp_min(-2.0)
    second = top[:, 1].clamp_min(-2.0)
    return best, second, torch.where(top[:, 0] > -2.0, idx, 0).int()


def _row_results(P: int, N: int, device):
    best = torch.empty(P, N, dtype=torch.float32, device=device)
    return best, torch.empty_like(best), torch.empty(P, N, dtype=torch.int32,
                                                     device=device)


def topk2_colmax_plain(
    d1: torch.Tensor, d2: torch.Tensor, valid1: torch.Tensor, valid2: torch.Tensor
):
    """Plain PyTorch version of :func:`match_topk2_colmax`, one pair at a
    time so only one (N, M) similarity is live."""
    P, N, _ = d1.shape
    best, second, best_idx = _row_results(P, N, d1.device)
    col_row = torch.empty(P, d2.shape[1], dtype=torch.int32, device=d1.device)
    for p in range(P):
        sim = similarity_plain(d1[p], d2[p])
        sim = torch.where(valid2[p][None, :], sim, -2.0)
        best[p], second[p], best_idx[p] = _row_top2(sim)
        sim_r = torch.where(valid1[p][:, None], sim, -2.0)
        col_row[p] = torch.argmax(sim_r, dim=0).int()
    return best, second, best_idx, col_row


def topk2_plain(d1: torch.Tensor, d2: torch.Tensor, valid2: torch.Tensor):
    """Plain PyTorch version of :func:`match_topk2`, one pair at a time."""
    P, N, _ = d1.shape
    best, second, best_idx = _row_results(P, N, d1.device)
    for p in range(P):
        sim = torch.where(valid2[p][None, :], similarity_plain(d1[p], d2[p]), -2.0)
        best[p], second[p], best_idx[p] = _row_top2(sim)
    return best, second, best_idx


def topk2_int8_plain(a1, a2, s1, s2, inv1, inv2, coef):
    """Plain PyTorch version of :func:`match_topk2_int8`, one pair at a
    time."""
    P, N, _ = a1.shape
    best, second, best_idx = _row_results(P, N, a1.device)
    for p in range(P):
        sim = int8_similarity_plain(a1[p], a2[p], s1[p], s2[p], inv1[p],
                                    inv2[p], coef)
        best[p], second[p], best_idx[p] = _row_top2(sim)
    return best, second, best_idx


def _check_pair(x1: torch.Tensor, x2: torch.Tensor, rows: dict, name: str):
    """Shapes of a (P, N, D) x (P, M, D) call and of its per-row tensors
    (``rows``: label -> (tensor, 1 for x1's rows or 2 for x2's))."""
    if x1.dim() != 3:
        raise ValueError(f"{name}: descriptors must be (P, N, D), got {tuple(x1.shape)}")
    P, N, D = x1.shape
    if x2.dim() != 3 or x2.shape[0] != P or x2.shape[2] != D:
        raise ValueError(f"{name}: {tuple(x1.shape)} and {tuple(x2.shape)} differ")
    for label, (t, side) in rows.items():
        want = (P, N if side == 1 else x2.shape[1])
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: {label} must be {want}, got {tuple(t.shape)}")


def _check_cuda(name: str, desc, masks, floats, desc_dtype: torch.dtype) -> None:
    """The kernels' input contract on the card: one CUDA device, contiguous;
    ``desc`` (the two descriptor tensors) of ``desc_dtype``, a multiple of
    WIDTH_STEP wide and 16-byte aligned, ``masks`` bool, ``floats`` f32; non-empty."""
    tensors = (*desc, *masks, *floats)
    for t in tensors:
        if t.device != desc[0].device or t.device.type != "cuda":
            raise ValueError(f"{name} kernel: all inputs on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel: contiguous inputs only")
    if any(t.dtype != desc_dtype for t in desc):
        raise ValueError(f"{name} kernel takes {desc_dtype} descriptors")
    if any(t.data_ptr() % 16 for t in desc):
        raise ValueError(f"{name} kernel needs 16-byte aligned rows")
    if any(t.dtype != torch.bool for t in masks):
        raise ValueError(f"{name} kernel takes bool masks")
    if any(t.dtype != torch.float32 for t in floats):
        raise ValueError(f"{name} kernel takes f32 row sums, norms and coef")
    P, N, D = desc[0].shape
    if not takes_width(D):
        raise NotImplementedError(
            f"{name} kernel takes widths that are multiples of {WIDTH_STEP}, got "
            f"D={D}: match it with ops.matching.match_pairs_batched"
        )
    if P == 0 or N == 0 or desc[1].shape[1] == 0:
        raise ValueError(f"{name} kernel needs non-empty inputs")


def match_topk2_colmax(
    d1: torch.Tensor, d2: torch.Tensor, valid1: torch.Tensor, valid2: torch.Tensor
):
    """(best, second, best_idx, col_row) for (P, N, D) x (P, M, D) f32.

    ``best``/``second``/``best_idx`` are each row's top-2 over valid columns;
    ``col_row`` is each column's argmax row over valid rows (first row
    wins).  CUDA tensors go to the kernel, CPU tensors to the plain
    version."""
    _check_pair(d1, d2, {"valid1": (valid1, 1), "valid2": (valid2, 2)},
                "match_topk2_colmax")
    if d1.device.type == "cpu":
        return topk2_colmax_plain(d1, d2, valid1, valid2)
    _check_cuda("match_topk2_colmax", (d1, d2), (valid1, valid2), (), torch.float32)
    P, N, _ = d1.shape
    M = d2.shape[1]
    nt = -(-N // TILE_N)
    best, second, best_idx = _row_results(P, N, d1.device)
    col_val = torch.empty(P, nt, M, dtype=torch.float32, device=d1.device)
    col_part = torch.empty(P, nt, M, dtype=torch.int32, device=d1.device)
    launch("match_topk2_colmax_launch", "match_topk2_colmax", d1, d2, valid1, valid2,
           best, second, best_idx, col_val, col_part, P, N, M, d1.shape[2])
    # Merge the per-row-tile column partials: the first tile holding the
    # max wins (argmax returns the first maximum), as in the reference.
    blk = torch.argmax(col_val, dim=1, keepdim=True)
    col_row = torch.take_along_dim(col_part, blk, dim=1)[:, 0]
    return best, second, best_idx, col_row


def match_topk2(d1: torch.Tensor, d2: torch.Tensor, valid2: torch.Tensor):
    """(best, second, best_idx): each row's top-2 over the valid columns of
    (P, N, D) x (P, M, D) f32.  CUDA tensors go to the kernel, CPU tensors to
    the plain version."""
    _check_pair(d1, d2, {"valid2": (valid2, 2)}, "match_topk2")
    if d1.device.type == "cpu":
        return topk2_plain(d1, d2, valid2)
    _check_cuda("match_topk2", (d1, d2), (valid2,), (), torch.float32)
    P, N, _ = d1.shape
    best, second, best_idx = _row_results(P, N, d1.device)
    launch("match_topk2_launch", "match_topk2", d1, d2, valid2, best, second, best_idx,
           P, N, d2.shape[1], d1.shape[2])
    return best, second, best_idx


def match_topk2_int8(a1, a2, s1, s2, inv1, inv2, coef):
    """(best, second, best_idx) over the exact cosines of (P, N, D) x
    (P, M, D) int8 descriptors ``a = q - 128`` with row sums ``s``, inverse
    norms ``inv`` (0 marks an invalid row) and (3,) ``coef`` from
    :func:`vit_colmap_tpu_torch.ops.matching.prepare_int8_descriptors`.
    CUDA tensors go to the kernel, CPU tensors to the plain version."""
    _check_pair(a1, a2, {"s1": (s1, 1), "s2": (s2, 2), "inv1": (inv1, 1),
                         "inv2": (inv2, 2)}, "match_topk2_int8")
    if coef.shape != (3,):
        raise ValueError(f"match_topk2_int8: coef must be (3,), got {tuple(coef.shape)}")
    if a1.device.type == "cpu":
        return topk2_int8_plain(a1, a2, s1, s2, inv1, inv2, coef)
    _check_cuda("match_topk2_int8", (a1, a2), (), (s1, s2, inv1, inv2, coef),
                torch.int8)
    P, N, _ = a1.shape
    best, second, best_idx = _row_results(P, N, a1.device)
    launch("match_topk2_int8_launch", "match_topk2_int8", a1, a2, s1, s2, inv1, inv2,
           coef, best, second, best_idx, P, N, a2.shape[1], a1.shape[2])
    return best, second, best_idx


def filter_matches(
    best: torch.Tensor,
    second: torch.Tensor,
    best_idx: torch.Tensor,
    col_row: torch.Tensor,
    valid1: torch.Tensor,
    max_ratio: float = 0.8,
    max_distance: float = 0.7,
    cross_check: bool = True,
) -> torch.Tensor:
    """COLMAP-style filters on the top-2 results -> (P, N) int32, -1 = none:
    keep a row iff arccos(best) <= max_distance, arccos(best) <= max_ratio *
    arccos(second) and, with ``cross_check``, the best column's best row
    (``col_row``) is this row."""
    dist_best = torch.arccos(best.clamp(-1.0, 1.0))
    dist_second = torch.arccos(second.clamp(-1.0, 1.0))
    keep = valid1 & (dist_best <= max_distance)
    keep &= dist_best <= max_ratio * dist_second
    if cross_check:
        back = torch.gather(col_row, 1, best_idx.long())
        keep &= back == torch.arange(best.shape[1], device=best.device)[None]
    return torch.where(keep, best_idx, -1).int()


def match_pairs(
    d1: torch.Tensor,
    d2: torch.Tensor,
    valid1: torch.Tensor,
    valid2: torch.Tensor,
    max_ratio: float = 0.8,
    max_distance: float = 0.7,
    cross_check: bool = True,
    fused_cross: bool = True,
) -> torch.Tensor:
    """Mutual-NN matching of (P, N, D) x (P, M, D) -> (P, N) int32.

    Counterpart of ``pallas_match_pairs``: with ``cross_check`` and
    ``fused_cross`` one :func:`match_topk2_colmax` pass; otherwise
    :func:`match_topk2`, run a second time with the arguments swapped for a
    two-pass cross-check.  Then :func:`filter_matches`."""
    if cross_check and fused_cross:
        return filter_matches(*match_topk2_colmax(d1, d2, valid1, valid2),
                              valid1, max_ratio, max_distance, cross_check)
    best, second, best_idx = match_topk2(d1, d2, valid2)
    col_row = match_topk2(d2, d1, valid1)[2] if cross_check else None
    return filter_matches(best, second, best_idx, col_row, valid1,
                          max_ratio, max_distance, cross_check)


def match_pairs_int8(
    a1, a2, s1, s2, inv1, inv2, coef,
    valid1: torch.Tensor,
    max_ratio: float = 0.8,
    max_distance: float = 0.7,
    cross_check: bool = True,
) -> torch.Tensor:
    """Counterpart of ``pallas_match_pairs_int8``: :func:`match_topk2_int8`,
    a second call with the arguments swapped for the cross-check, and
    :func:`filter_matches` (``valid1`` for the keep mask; ``inv`` encodes
    validity too)."""
    best, second, best_idx = match_topk2_int8(a1, a2, s1, s2, inv1, inv2, coef)
    col_row = None
    if cross_check:
        col_row = match_topk2_int8(a2, a1, s2, s1, inv2, inv1, coef)[2]
    return filter_matches(best, second, best_idx, col_row, valid1,
                          max_ratio, max_distance, cross_check)
