"""Plain mutual nearest-neighbour matching of signed uint8 descriptors with
COLMAP's tests, in float64 (or, for the control, in a lower precision).

A row a of image 1 matches column b of image 2 when b is a's most similar
valid descriptor (the first one on ties), a is b's most similar valid row,
acos(s_ab) <= max_distance and acos(s_ab) <= max_ratio * acos(second best
of row a).  Descriptors decode as u / 127.5 - 1 and are L2-normalised.
Written from that description; it shares no code with the program."""

from __future__ import annotations

import torch

PRECISIONS = ("f64", "f32", "tf32", "bf16")


def decode(desc_u8: torch.Tensor, valid: torch.Tensor, dtype=torch.float64) -> torch.Tensor:
    d = desc_u8.to(dtype) / 127.5 - 1.0
    d = torch.where(valid[..., None], d, 0.0)
    return d / d.norm(dim=-1, keepdim=True).clamp_min(1e-8)


def similarity(d1: torch.Tensor, d2: torch.Tensor, precision: str) -> torch.Tensor:
    """(P, N, D) x (P, M, D) -> (P, N, M) cosines in ``precision``, returned
    as float64."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}")
    if precision == "f64":
        return d1.double() @ d2.double().transpose(-1, -2)
    if precision == "bf16":
        return (d1.bfloat16() @ d2.bfloat16().transpose(-1, -2)).double()
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = precision == "tf32"
    try:
        return (d1.float() @ d2.float().transpose(-1, -2)).double()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def mutual(sim: torch.Tensor, v1: torch.Tensor, v2: torch.Tensor, max_ratio: float,
           max_distance: float) -> dict:
    """From (P, N, M) similarities and validity: ``match`` (P, N) column or
    -1, each row's ``best``, ``second`` and ``best_idx`` over valid columns,
    and each column's best value over valid rows ``col_best``."""
    s = torch.where(v2[:, None, :], sim, -2.0)
    top = torch.topk(s, 2, dim=-1).values
    best_idx = torch.argmax(s, dim=-1)
    s_cols = torch.where(v1[:, :, None], s, -2.0)
    col_best = s_cols.amax(dim=1)
    col_row = torch.argmax(s_cols, dim=1)
    del s_cols
    best, second = top[..., 0], top[..., 1]
    dist = torch.arccos(best.clamp(-1.0, 1.0))
    keep = v1 & (dist <= max_distance)
    keep &= dist <= max_ratio * torch.arccos(second.clamp(-1.0, 1.0))
    rows = torch.arange(sim.shape[1], device=sim.device)[None]
    keep &= torch.gather(col_row, 1, best_idx) == rows
    return {"match": torch.where(keep, best_idx, -1), "best": best, "second": second,
            "best_idx": best_idx, "col_best": col_best}


def pair_matcher(precision: str):
    """A matcher with the program's pair-matcher signature ``(d1, d2, v1,
    v2, max_ratio, max_distance, cross_check) -> (P, N) int32`` that runs
    this reference in ``precision``: the control put in the program's
    place."""

    def run(d1, d2, v1, v2, max_ratio=0.8, max_distance=0.7, cross_check=True):
        if not cross_check:
            raise ValueError("the reference matches mutually")
        out = mutual(similarity(d1, d2, precision), v1, v2, max_ratio, max_distance)
        return out["match"].to(torch.int32)

    return run
