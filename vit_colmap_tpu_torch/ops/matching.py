"""Exhaustive descriptor matching: the plain PyTorch matcher and helpers.

Counterpart of ``vit_colmap_tpu/ops/matching.py``.  COLMAP SIFT-matcher
semantics: L2-normalized descriptors, cosine similarity, angular distance
``acos(sim)``; a match is kept iff ``acos(best) <= max_distance``,
``acos(best) <= max_ratio * acos(second)`` and, with ``cross_check``, it is
a mutual nearest neighbour.  ``match_pair`` matches one pair, and
``match_pairs_batched``, the same body over a batch, is the straightforward
matmul + top-2 matcher (the reference's, for ``use_pallas=False`` and for
widths that are not a multiple of 128); the pipeline otherwise matches with
the kernels (``kernels/match.py``), which compute the same function without
the (N, M) similarity in memory.  ``prepare_int8_descriptors`` feeds the int8
matcher.
"""

from __future__ import annotations

import numpy as np
import torch

from vit_colmap_tpu_torch.kernels import match as match_kernel


def match_pair(
    d1: torch.Tensor,  # (N, D) f32, L2-normalized rows
    d2: torch.Tensor,  # (M, D)
    valid1: torch.Tensor,  # (N,) bool
    valid2: torch.Tensor,  # (M,) bool
    max_ratio: float = 0.8,
    max_distance: float = 0.7,
    cross_check: bool = True,
) -> torch.Tensor:
    """Match one padded descriptor pair: (N,) int32, each row's matched
    column in image 2, or -1.  :func:`match_pairs_batched` on a batch of
    one."""
    return match_pairs_batched(d1[None], d2[None], valid1[None], valid2[None], max_ratio,
                               max_distance, cross_check)[0]


def match_pairs_batched(
    d1: torch.Tensor,  # (P, N, D) f32, L2-normalized rows
    d2: torch.Tensor,  # (P, M, D)
    valid1: torch.Tensor,  # (P, N) bool
    valid2: torch.Tensor,  # (P, M) bool
    max_ratio: float = 0.8,
    max_distance: float = 0.7,
    cross_check: bool = True,
) -> torch.Tensor:
    """(P, N) int32: each row's matched column in image 2, or -1.

    The plain reference: one matmul, top-2 and column argmax, then the
    filters of :func:`match_kernel.filter_matches`."""
    sim = d1 @ d2.transpose(-1, -2)
    sim = torch.where(valid2[:, None, :], sim, -2.0)
    top2 = torch.topk(sim, 2, dim=-1).values
    best_idx = torch.argmax(sim, dim=-1)  # first maximum, as lax.top_k
    col_row = torch.argmax(torch.where(valid1[:, :, None], sim, -2.0), dim=1)
    return match_kernel.filter_matches(
        top2[..., 0], top2[..., 1], best_idx, col_row, valid1,
        max_ratio, max_distance, cross_check,
    )


def prepare_int8_descriptors(desc_u8: torch.Tensor, valid: torch.Tensor, encoding: str):
    """uint8 descriptors -> exact int8-matmul matching operands for
    :func:`match_kernel.match_pairs_int8`.

    Decoded descriptors are an affine map of q: ``u = q`` (unsigned) or
    ``u = 2q - 255`` (the signed ViT encoding, scaled by 2 to stay integral;
    cosine is scale-invariant).  With ``a = q - 128`` (int8):

        u1 . u2 = alpha * (a1 . a2) + beta * (sum(a1) + sum(a2)) + gamma

    where (alpha, beta, gamma) = (1, 128, 128^2 D) for unsigned and
    (4, 2, D) for signed.

    Returns (a int8 (..., N, D), sums f32 (..., N), inv_norms f32 (..., N)
    with 0 marking invalid rows, coef f32 (3,)).  Where a row's squared norm
    is below 2^24, it is a sum of integer squares that f32 holds exactly in
    any order, and ``vector_norm`` rounds its square root correctly
    (``torch.sqrt`` on the CPU does not always): every output is then
    bit-equal to the reference's.  That holds for every row up to D = 256
    (255^2 * 256 < 2^24).  At D = 384 it holds for real quantized
    descriptors (a signed descriptor of unit norm has |u|^2 near 255^2) and
    for uniform random bytes (|u|^2 near 255^2 * D / 3), but not for rows
    near the largest norm, 255^2 * 384 = 2.5e7.
    """
    q = desc_u8.to(torch.int32)
    a = (q - 128).to(torch.int8)
    s = (q - 128).sum(-1).float()
    D = desc_u8.shape[-1]
    if encoding == "signed":
        u = (2 * q - 255).float()
        coef = [4.0, 2.0, float(D)]
    else:
        u = q.float()
        coef = [1.0, 128.0, 128.0 * 128.0 * D]
    norms = torch.linalg.vector_norm(u, dim=-1)
    inv = torch.where(valid & (norms > 1e-6), 1.0 / torch.clamp_min(norms, 1e-6), 0.0)
    coef = torch.tensor(coef, dtype=torch.float32, device=desc_u8.device)
    return a, s, inv.float(), coef


def get_pair_matcher(use_pallas: bool | None = None):
    """``(d1, d2, v1, v2, max_ratio, max_distance, cross_check) -> (P, N)``,
    dispatched as the reference's matcher is.

    ``use_pallas`` keeps the reference's knob.  None or True: descriptors
    whose width is a multiple of 128 (``match_kernel.WIDTH_STEP``) go to the
    matching kernel, which takes its plain version on CPU tensors; other
    widths go to :func:`match_pairs_batched`, the reference's matmul matcher,
    on either device.  The reference also asks N to be a multiple of 128, a
    tiling need of its TPU kernel; the port's kernels mask ragged rows and
    columns themselves.  False: always :func:`match_pairs_batched`."""
    if use_pallas is False:
        return match_pairs_batched

    def matcher(d1, d2, v1, v2, max_ratio=0.8, max_distance=0.7, cross_check=True):
        if not match_kernel.takes_width(d1.shape[-1]):
            return match_pairs_batched(d1, d2, v1, v2, max_ratio, max_distance,
                                       cross_check)
        return match_kernel.match_pairs(
            d1.contiguous(), d2.contiguous(), v1.contiguous(), v2.contiguous(),
            max_ratio, max_distance, cross_check,
        )

    return matcher


def compact_matches(match_idx: np.ndarray, n_valid1: int) -> np.ndarray:
    """(N,) row -> col match indices with -1 padding -> (R, 2) uint32."""
    match_idx = np.asarray(match_idx[:n_valid1])
    rows = np.nonzero(match_idx >= 0)[0]
    return np.stack([rows, match_idx[rows]], axis=1).astype(np.uint32)


PACK_SENTINEL = 2**31 - 1  # sorts after any packed (row, col)


def compact_matches_device(match_idx: torch.Tensor):
    """(P, N) matches -> (counts (P,), packed (P, N)): each match packed as
    ``(row << 16) | col`` and sorted to the front of its row, so that a
    row's matches are its first ``count`` entries (:func:`unpack_matches`)."""
    n = match_idx.shape[-1]
    rows = torch.arange(n, dtype=torch.int32, device=match_idx.device)
    matched = match_idx >= 0
    counts = matched.sum(dim=-1).int()
    packed = torch.where(matched, (rows << 16) | match_idx, PACK_SENTINEL)
    return counts, torch.sort(packed, dim=-1).values


def unpack_matches(packed_row: np.ndarray, count: int) -> np.ndarray:
    """One row of ``compact_matches_device`` output -> (R, 2) uint32."""
    p = np.asarray(packed_row[:count]).astype(np.uint32)
    return np.stack([p >> 16, p & 0xFFFF], axis=1).astype(np.uint32)
