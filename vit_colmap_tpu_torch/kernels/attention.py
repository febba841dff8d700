"""Kernels 1 and 3: fixed-max softmax attention, on the packed qkv projection
and on head-major tensors.

Counterparts of ``vit_colmap_tpu/ops/pallas/attention_kernel.py``
``fixed_max_attention_qkv`` (:func:`attention_qkv`) and
``fixed_max_attention`` (:func:`fixed_max_attention`).  Both call one
launcher, ``csrc/fixed_max_attention.cu``, which reads strided (batch, head,
token, dim) views: the packed layout is a set of strides, not a copy.  bf16
views go to the Hopper body (TMA-fed ``wgmma``), which reads each view
through a 4-D tensor map described by :func:`tma_layout`; f32 views go to
the SIMT body.

Numerics: q is scaled by ``sm_scale * log2(e)`` in f32 and rounded back to
the input dtype, ``p = exp2(min(s, 100))`` with no running max, p rounded to
bf16, f32 sums, denominator floored at 1e-30.  Inference only.
"""

from __future__ import annotations

import ctypes
import math

import torch

from vit_colmap_tpu_torch.kernels.build import launch

LOG2E = math.log2(math.e)
CLAMP = 100.0
MAX_HEAD_DIM = 64
# One TMA tile of the bf16 body: (dims, tokens, heads, images).
TMA_BOX = (64, 128, 1, 1)
DTYPE_BYTES = {torch.bfloat16: 2, torch.float32: 4}


def takes_attention_qkv(dim: int, num_heads: int) -> bool:
    """Whether kernel 1 takes a model width ``dim`` split into ``num_heads``
    heads: head dim 64 and an even head count."""
    return dim == num_heads * 64 and num_heads % 2 == 0


def takes_fixed_max_attention(head_dim: int) -> bool:
    """Whether kernel 3 takes heads of ``head_dim``: at most MAX_HEAD_DIM."""
    return head_dim <= MAX_HEAD_DIM


def _check_layout(qkv: torch.Tensor, num_heads: int) -> int:
    if qkv.dim() != 3:
        raise ValueError(f"qkv must be (B, N, 3*D), got {tuple(qkv.shape)}")
    three_d = qkv.shape[-1]
    if three_d % 3 or not takes_attention_qkv(three_d // 3, num_heads):
        raise ValueError(
            "attention_qkv requires head_dim == 64 and an even head count, got "
            f"width {three_d} with {num_heads} heads"
        )
    return three_d // 3


def _check_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            "q, k, v must share one (B, H, N, d) shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if not takes_fixed_max_attention(q.shape[-1]):
        raise ValueError(
            f"fixed_max_attention is specialized for head_dim <= {MAX_HEAD_DIM}, "
            f"got {q.shape[-1]}"
        )


def _split_heads(qkv: torch.Tensor, num_heads: int):
    """(B, N, 3*D) packed ``[q | k | v]`` -> three (B, H, N, 64) views."""
    B, N, three_d = qkv.shape
    D = three_d // 3
    return tuple(
        qkv[..., i * D : (i + 1) * D].view(B, N, num_heads, 64).transpose(1, 2)
        for i in range(3)
    )


def _empty_out(q: torch.Tensor) -> torch.Tensor:
    """(B, H, N, d) view of a (B, N, H, d) tensor: merging the heads back
    into (B, N, H*d) is then a free reshape."""
    B, H, N, d = q.shape
    return torch.empty(B, N, H, d, dtype=q.dtype, device=q.device).transpose(1, 2)


def fixed_max_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sm_scale: float
) -> torch.Tensor:
    """Plain PyTorch version: the kernel's arithmetic, one (image, head) at a
    time so that only one (N, N) score matrix is live."""
    _check_heads(q, k, v)
    out = _empty_out(q)
    scale = float(sm_scale) * LOG2E
    for b in range(q.shape[0]):
        for h in range(q.shape[1]):
            qs = (q[b, h].float() * scale).to(q.dtype).float()
            s = qs @ k[b, h].float().T
            p = torch.exp2(torch.clamp_max(s, CLAMP)).to(torch.bfloat16).float()
            den = p.sum(-1, keepdim=True).clamp_min(1e-30)
            out[b, h] = ((p @ v[b, h].float()) / den).to(q.dtype)
    return out


def attention_qkv_plain(
    qkv: torch.Tensor, num_heads: int, sm_scale: float
) -> torch.Tensor:
    """Plain PyTorch version of :func:`attention_qkv`."""
    _check_layout(qkv, num_heads)
    out = fixed_max_attention_plain(*_split_heads(qkv, num_heads), sm_scale)
    return out.transpose(1, 2).reshape(qkv.shape[0], qkv.shape[1], -1)


def tma_ready(t: torch.Tensor) -> bool:
    """Whether the bf16 body's TMA can read a (B, H, N, d) view in place:
    d % 8 == 0, a 16-byte aligned base, and batch / head / token strides that
    are positive multiples of 8 elements (16 bytes)."""
    return (
        t.shape[-1] % 8 == 0
        and t.data_ptr() % 16 == 0
        and all(s > 0 and s % 8 == 0 for s in t.stride()[:3])
    )


def tma_operand(t: torch.Tensor) -> torch.Tensor:
    """The view itself when :func:`tma_ready`, else a copy into zero-padded
    (B, H, N, ceil(d / 8) * 8) storage: a layout step on the same device."""
    if tma_ready(t):
        return t
    B, H, N, d = t.shape
    padded = t.new_zeros(B, H, N, -(-d // 8) * 8)
    padded[..., :d] = t
    return padded


def tma_layout(t: torch.Tensor) -> dict:
    """The tensor map that ``fixed_max_attention_launch`` encodes for one
    (B, H, N, d) operand view: dims innermost first (d, N, H, B), byte
    strides of the token, head and batch axes, and the box.  Tokens have an
    axis of their own, so a box that runs past N is zero-filled by TMA and
    never reads the next image or head; so is a box dim past d."""
    B, H, N, d = t.shape
    e = t.element_size()
    sb, sh, sn = t.stride()[:3]
    return {"dims": (d, N, H, B), "strides": (sn * e, sh * e, sb * e), "box": TMA_BOX}


def _launch(q, k, v, out, sm_scale: float, name: str) -> torch.Tensor:
    """One launch of the CUDA kernel on (B, H, N, d) views; returns ``out``.

    bf16 views that TMA cannot read in place are first copied by
    :func:`tma_operand`, and a padded head dim is cut off the result."""
    if out.device.type != "cuda":
        raise ValueError(f"{name} kernel runs on CUDA tensors, got {out.device}")
    for t in (q, k, v):
        if t.device != out.device or t.dtype != out.dtype or t.dtype not in DTYPE_BYTES:
            raise ValueError(
                f"{name} kernel takes bf16 or f32 tensors of one dtype on one CUDA "
                f"device, got {t.dtype} on {t.device}"
            )
        if t.stride(-1) != 1:
            raise ValueError(f"{name} kernel needs unit stride along head_dim")
    B, H, N, d = q.shape
    if B == 0 or H == 0 or N == 0 or d == 0:
        return out
    target = out
    if q.dtype == torch.bfloat16:
        q, k, v = (tma_operand(t) for t in (q, k, v))
        if q.shape[-1] != d:
            target = _empty_out(q)
    strides = [s for t in (q, k, v, target) for s in t.stride()[:3]]
    launch("fixed_max_attention_launch", name, q, k, v, target, B, H, N, q.shape[-1],
           (ctypes.c_longlong * 12)(*strides), float(sm_scale) * LOG2E,
           DTYPE_BYTES[q.dtype])
    if target is not out:
        out.copy_(target[..., :d])
    return out


def fixed_max_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sm_scale: float
) -> torch.Tensor:
    """Kernel 3: (B, H, N, d <= 64) -> (B, H, N, d), non-causal.

    Takes strided views (unit stride along d), so a caller can pass the
    permuted heads of its qkv projection without a copy.  The result is a
    (B, H, N, d) view of (B, N, H, d) storage.  CUDA tensors (bf16 or f32)
    go to the kernel, CPU tensors to the plain version."""
    _check_heads(q, k, v)
    if q.device.type == "cpu":
        return fixed_max_attention_plain(q, k, v, sm_scale)
    return _launch(q, k, v, _empty_out(q), sm_scale, "fixed_max_attention")


def attention_qkv(
    qkv: torch.Tensor, num_heads: int, sm_scale: float
) -> torch.Tensor:
    """Kernel 1: packed (B, N, 3*D) ``[q | k | v]`` (head h at columns
    64h..64h+63 of each section) -> (B, N, D).  The CUDA kernel for a CUDA
    tensor (bf16 or f32, contiguous), the plain version for a CPU tensor."""
    if qkv.device.type == "cpu":
        return attention_qkv_plain(qkv, num_heads, sm_scale)
    D = _check_layout(qkv, num_heads)
    if not qkv.is_contiguous():
        raise ValueError("attention_qkv kernel needs a contiguous qkv")
    B, N, _ = qkv.shape
    q, k, v = _split_heads(qkv, num_heads)
    out = _launch(q, k, v, _empty_out(q), sm_scale, "attention_qkv")
    return out.transpose(1, 2).reshape(B, N, D)
