"""Operations, bytes and least times of the kernels and model steps the
benchmark measures, from shapes alone, and the table of peaks beside this
file.  A least time is the larger of operations over the peak rate of the
arithmetic's type and bytes over the memory's rate; each input byte is
counted read once and each output byte written once."""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())


def peak_flops(dtype: str) -> float:
    return PEAKS["flops"][dtype]


def least_s(flops: float, nbytes: float, dtype: str) -> float:
    return max(flops / peak_flops(dtype), nbytes / PEAKS["bytes_per_s"])


def attention_flops(batch: int, tokens: int, width: int) -> float:
    """Q K^T and P V of every head: 2 products of 2 * N * N * head_dim per
    head and image, so 4 * B * N^2 * D."""
    return 4.0 * batch * tokens * tokens * width


def attention_bytes(batch: int, tokens: int, width: int, elem: int = 2) -> float:
    """The packed qkv read once and the output written once."""
    return batch * tokens * 4 * width * elem


def attention_least_s(batch: int, tokens: int, width: int, dtype: str = "bf16") -> float:
    elem = 4 if dtype == "fp32" else 2
    return least_s(attention_flops(batch, tokens, width),
                   attention_bytes(batch, tokens, width, elem), dtype)


def match_flops(pairs: int, rows: int, cols: int, dim: int) -> float:
    """Every similarity of every pair: 2 * K1 * K2 * D a pair."""
    return 2.0 * pairs * rows * cols * dim


def match_bytes(pairs: int, rows: int, cols: int, dim: int, elem: int = 4) -> float:
    """Both descriptor sets read once; each row's best, second and index and
    each column's best row written once."""
    return pairs * ((rows + cols) * dim * elem + rows * 12 + cols * 4)


def match_least_s(pairs: int, rows: int, cols: int, dim: int, dtype: str = "fp32") -> float:
    elem = 1 if dtype == "int8" else 4
    return least_s(match_flops(pairs, rows, cols, dim),
                   match_bytes(pairs, rows, cols, dim, elem), dtype)


def vit_tokens(height: int, width: int, patch: int, extra_tokens: int = 1) -> int:
    return (height // patch) * (width // patch) + extra_tokens


def vit_forward_flops(cfg: dict, height: int, width: int) -> float:
    """Model FLOPs of one image through the backbone at its published
    widths: 2 * (matmul parameters) * tokens for the blocks' dense layers,
    4 * N^2 * D a block for attention, and the patch embedding."""
    d, depth, p = cfg["hidden_size"], cfg["num_hidden_layers"], cfg["patch_size"]
    hidden = cfg["intermediate_size"]
    n = vit_tokens(height, width, p)
    patches = (height // p) * (width // p)
    dense = depth * (4 * d * d + 2 * d * hidden)  # qkv, proj, fc1, fc2
    return 2.0 * dense * n + 4.0 * n * n * d * depth + 2.0 * 3 * p * p * d * patches
