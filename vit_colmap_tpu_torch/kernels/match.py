"""Kernel 2: fused row top-2 + column argmax for mutual-NN matching.

Counterpart of ``vit_colmap_tpu/ops/pallas/match_kernel.py``
``pallas_topk2_colmax`` and ``pallas_match_pairs``; the CUDA source is
``csrc/match_topk2_colmax.cu``.

Similarities are fp32 FMA chains in a fixed order over the descriptor
dimension (``s = fma(d1[d], d2[d], s)`` for d = 0..D-1).  The plain version
repeats that order, so kernel and plain version agree bit for bit and break
near-ties the same way.
"""

from __future__ import annotations

import torch

DIM = 128  # descriptor width the kernel is compiled for
TILE_N = 64  # row tile of the kernel's column partials

launches = 0  # kernel launches since the last reset


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


def topk2_colmax_plain(
    d1: torch.Tensor, d2: torch.Tensor, valid1: torch.Tensor, valid2: torch.Tensor
):
    """Plain PyTorch version of :func:`match_topk2_colmax`, one pair at a
    time so only one (N, M) similarity is live."""
    P, N, _ = d1.shape
    best = torch.empty(P, N, dtype=torch.float32, device=d1.device)
    second = torch.empty_like(best)
    best_idx = torch.empty(P, N, dtype=torch.int32, device=d1.device)
    col_row = torch.empty(P, d2.shape[1], dtype=torch.int32, device=d1.device)
    for p in range(P):
        sim = similarity_plain(d1[p], d2[p])
        sim = torch.where(valid2[p][None, :], sim, -2.0)
        top = torch.topk(sim, 2, dim=1).values
        # Seeded at (-2, -2, index 0) and replaced on a strict '>': the first
        # column reaching the max wins (argmax returns the first maximum).
        idx = torch.argmax(sim, dim=1)
        best[p] = top[:, 0].clamp_min(-2.0)
        second[p] = top[:, 1].clamp_min(-2.0)
        best_idx[p] = torch.where(top[:, 0] > -2.0, idx, 0).int()
        sim_r = torch.where(valid1[p][:, None], sim, -2.0)
        col_row[p] = torch.argmax(sim_r, dim=0).int()
    return best, second, best_idx, col_row


def _check(d1, d2, valid1, valid2):
    P, N, D = d1.shape
    if d2.dim() != 3 or d2.shape[0] != P or d2.shape[2] != D:
        raise ValueError(f"d1 {tuple(d1.shape)} and d2 {tuple(d2.shape)} differ")
    if valid1.shape != (P, N) or valid2.shape != (P, d2.shape[1]):
        raise ValueError("valid masks must be (P, N) and (P, M)")


def match_topk2_colmax(
    d1: torch.Tensor, d2: torch.Tensor, valid1: torch.Tensor, valid2: torch.Tensor
):
    """(best, second, best_idx, col_row) for (P, N, D) x (P, M, D) f32.

    ``best``/``second``/``best_idx`` are each row's top-2 over valid columns
    (invalid columns read as -2, first column wins ties); ``col_row`` is each
    column's argmax row over valid rows (first row wins).  CUDA tensors go to
    the kernel, CPU tensors to the plain version."""
    _check(d1, d2, valid1, valid2)
    if d1.device.type == "cpu":
        return topk2_colmax_plain(d1, d2, valid1, valid2)
    global launches
    from vit_colmap_tpu_torch.kernels.build import check, library

    for t in (d1, d2, valid1, valid2):
        if t.device != d1.device or t.device.type != "cuda":
            raise ValueError("match_topk2_colmax kernel: all inputs on one "
                             "CUDA device")
        if not t.is_contiguous():
            raise ValueError("match_topk2_colmax kernel: contiguous inputs only")
    if d1.dtype != torch.float32 or d2.dtype != torch.float32:
        raise ValueError("match_topk2_colmax kernel takes f32 descriptors")
    if d1.data_ptr() % 16 or d2.data_ptr() % 16:
        raise ValueError("match_topk2_colmax kernel needs 16-byte aligned rows")
    if valid1.dtype != torch.bool or valid2.dtype != torch.bool:
        raise ValueError("match_topk2_colmax kernel takes bool masks")
    P, N, D = d1.shape
    M = d2.shape[1]
    if D != DIM:
        raise NotImplementedError(
            f"match_topk2_colmax kernel is built for D={DIM}, got {D}: other "
            "widths are not ported yet"
        )
    if P == 0 or N == 0 or M == 0:
        raise ValueError("match_topk2_colmax kernel needs non-empty inputs")
    nt = -(-N // TILE_N)
    dev = d1.device
    best = torch.empty(P, N, dtype=torch.float32, device=dev)
    second = torch.empty(P, N, dtype=torch.float32, device=dev)
    best_idx = torch.empty(P, N, dtype=torch.int32, device=dev)
    col_val = torch.empty(P, nt, M, dtype=torch.float32, device=dev)
    col_part = torch.empty(P, nt, M, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = library().match_topk2_colmax_launch(
            d1.data_ptr(), d2.data_ptr(), valid1.data_ptr(), valid2.data_ptr(),
            best.data_ptr(), second.data_ptr(), best_idx.data_ptr(),
            col_val.data_ptr(), col_part.data_ptr(), P, N, M, stream,
        )
    check(err, "match_topk2_colmax")
    launches += 1
    # Merge the per-row-tile column partials: the first tile holding the
    # max wins (argmax returns the first maximum), as in the reference.
    blk = torch.argmax(col_val, dim=1, keepdim=True)
    col_row = torch.take_along_dim(col_part, blk, dim=1)[:, 0]
    return best, second, best_idx, col_row


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
    arccos(second) and, with ``cross_check``, the best column's best row is
    this row."""
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
) -> torch.Tensor:
    """Mutual-NN matching of (P, N, D) x (P, M, D) -> (P, N) int32.

    Counterpart of ``pallas_match_pairs`` with ``fused_cross=True``: one
    :func:`match_topk2_colmax` pass, then :func:`filter_matches`."""
    return filter_matches(
        *match_topk2_colmax(d1, d2, valid1, valid2), valid1,
        max_ratio, max_distance, cross_check,
    )
