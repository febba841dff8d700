"""Kernel 1: fixed-max softmax attention on the packed qkv projection.

Counterpart of ``vit_colmap_tpu/ops/pallas/attention_kernel.py``
``fixed_max_attention_qkv``; the CUDA source is ``csrc/attention_qkv.cu``.

(B, N, 3*D) packed ``[q | k | v]`` (head h at columns 64h..64h+63 of each
section) -> (B, N, D).  Numerics: q is scaled by ``sm_scale * log2(e)`` in
f32 and rounded back to the input dtype, ``p = exp2(min(s, 100))`` with no
running max, p rounded to bf16, f32 sums, denominator floored at 1e-30.
Inference only.
"""

from __future__ import annotations

import math

import torch

LOG2E = math.log2(math.e)
CLAMP = 100.0

launches = 0  # kernel launches since the last reset


def _check_layout(qkv: torch.Tensor, num_heads: int) -> int:
    if qkv.dim() != 3:
        raise ValueError(f"qkv must be (B, N, 3*D), got {tuple(qkv.shape)}")
    three_d = qkv.shape[-1]
    if three_d % 3 or three_d // 3 != num_heads * 64 or num_heads % 2:
        raise ValueError(
            "attention_qkv requires head_dim == 64 and an even head count, got "
            f"width {three_d} with {num_heads} heads"
        )
    return three_d // 3


def attention_qkv_plain(
    qkv: torch.Tensor, num_heads: int, sm_scale: float
) -> torch.Tensor:
    """Plain PyTorch version: the kernel's arithmetic, one head at a time so
    that only one (N, N) score matrix per image is live."""
    D = _check_layout(qkv, num_heads)
    B, N, _ = qkv.shape
    out = torch.empty(B, N, D, dtype=qkv.dtype, device=qkv.device)
    scale = float(sm_scale) * LOG2E
    for h in range(num_heads):
        q = qkv[..., 64 * h : 64 * h + 64].float() * scale
        q = q.to(qkv.dtype).float()
        k = qkv[..., D + 64 * h : D + 64 * h + 64].float()
        v = qkv[..., 2 * D + 64 * h : 2 * D + 64 * h + 64].float()
        for b in range(B):
            s = q[b] @ k[b].T
            p = torch.exp2(torch.clamp_max(s, CLAMP)).to(torch.bfloat16).float()
            den = p.sum(-1, keepdim=True).clamp_min(1e-30)
            out[b, :, 64 * h : 64 * h + 64] = ((p @ v[b]) / den).to(qkv.dtype)
    return out


def attention_qkv(
    qkv: torch.Tensor, num_heads: int, sm_scale: float
) -> torch.Tensor:
    """Packed-qkv attention: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    if qkv.device.type == "cpu":
        return attention_qkv_plain(qkv, num_heads, sm_scale)
    global launches
    from vit_colmap_tpu_torch.kernels.build import check, library

    D = _check_layout(qkv, num_heads)
    if qkv.device.type != "cuda" or qkv.dtype != torch.bfloat16:
        raise ValueError(
            f"attention_qkv kernel takes bf16 CUDA tensors, got {qkv.dtype} "
            f"on {qkv.device}"
        )
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("attention_qkv kernel needs a contiguous, 16-byte "
                         "aligned qkv")
    B, N, _ = qkv.shape
    out = torch.empty(B, N, D, dtype=qkv.dtype, device=qkv.device)
    if B == 0 or N == 0:
        return out
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = library().attention_qkv_launch(
            qkv.data_ptr(), out.data_ptr(), B, N, num_heads,
            float(sm_scale) * LOG2E, stream,
        )
    check(err, "attention_qkv")
    launches += 1
    return out
