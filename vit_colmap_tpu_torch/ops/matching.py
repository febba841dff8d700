"""Exhaustive descriptor matching: the plain PyTorch matcher and helpers.

Counterpart of ``vit_colmap_tpu/ops/matching.py``.  COLMAP SIFT-matcher
semantics: L2-normalized descriptors, cosine similarity, angular distance
``acos(sim)``; a match is kept iff ``acos(best) <= max_distance``,
``acos(best) <= max_ratio * acos(second)`` and, with ``cross_check``, it is
a mutual nearest neighbour.  ``match_pairs_batched`` is the straightforward
matmul + top-2 reference; the pipeline matches with the kernel
(``kernels/match.py``), which computes the same function in one pass.
"""

from __future__ import annotations

import numpy as np
import torch

from vit_colmap_tpu_torch.kernels import match as match_kernel


def normalize_descriptors(desc: torch.Tensor) -> torch.Tensor:
    """uint8/float descriptors -> L2-normalized float32 rows."""
    d = desc.float()
    return d / torch.clamp_min(torch.linalg.norm(d, dim=-1, keepdim=True), 1e-8)


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


def get_pair_matcher(use_pallas: bool | None = None):
    """``(d1, d2, v1, v2, max_ratio, max_distance, cross_check) -> (P, N)``:
    the matching kernel, which takes its plain version on CPU tensors.

    ``use_pallas`` keeps the reference's knob; None and True select the
    kernel, and False (the reference's matmul matcher) is not ported."""
    if use_pallas is False:
        raise NotImplementedError(
            "MatchingConfig.use_pallas=False (the matmul matcher) is not "
            "ported: the port always matches with its kernel"
        )

    def matcher(d1, d2, v1, v2, max_ratio=0.8, max_distance=0.7, cross_check=True):
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
    ``(row << 16) | col`` and sorted to the front of its row, so the host
    reads counts and a short prefix instead of the whole array."""
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
