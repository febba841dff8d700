"""The add-and-norm kernel: residual add, LayerScale and LayerNorm at one
block boundary of the backbone, ``csrc/add_norm.cu``.

It replaces no TPU kernel: the JAX package leaves this elementwise work to
XLA, which fuses it; the port's eager forward ran it as five passes over the
residual stream.  One call takes the bf16 residual ``x`` (T, D), the block's
bf16 ``branch`` output (or none, before the first block), the LayerScale
``gamma`` and the next LayerNorm's f32 affine, and returns

    x_new = bf16(x + bf16(branch * bf16(gamma)))     (x itself without a branch)
    y     = LayerNorm(f32(x_new)) in ``out_dtype``   (f32 mean and biased variance)

``x_new`` equals the plain version bit for bit; ``y`` differs from it only
by the order of the f32 sums (PyTorch's LayerNorm takes Welford's, the
kernel two passes).  Inference only: it has no backward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vit_colmap_tpu_torch.kernels.build import launch

MAX_DIM = 2048
OUT_DTYPES = (torch.bfloat16, torch.float32)


def add_norm_plain(x, branch, gamma, weight, bias, eps: float, out_dtype: torch.dtype):
    """Plain PyTorch version, the backbone's ops before the kernel:
    ``x + branch * gamma.to(bf16)`` (LayerScale, then the residual add),
    then LayerNorm on an f32 copy and a cast to ``out_dtype``.  Any dtype,
    any device, with autograd.  Returns ``(x_new, y)``."""
    if branch is not None:
        x = x + branch * gamma.to(branch.dtype)
    y = F.layer_norm(x.float(), (x.shape[-1],), weight, bias, eps)
    return x, y.to(out_dtype)


def records_grad(*tensors) -> bool:
    """Whether autograd records a graph through any of ``tensors`` (None
    entries are skipped)."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def takes_kernel(x, branch, gamma, weight, bias) -> bool:
    """Whether a block boundary is the kernel's: a bf16 stream on the card
    whose forward records no gradient.  Any other (CPU tensors, an f32
    stream, a forward that records gradients, since the kernel has no
    backward) takes :func:`add_norm_plain`."""
    return (x.is_cuda and x.dtype == torch.bfloat16
            and not records_grad(x, branch, gamma, weight, bias))


def _check(x, branch, gamma, weight, bias, out_dtype) -> None:
    D = x.shape[-1]
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError(f"add_norm kernel takes a contiguous bf16 x, got {x.dtype}")
    if D % 8 or not 8 <= D <= MAX_DIM:
        raise ValueError(f"add_norm kernel takes widths that are multiples of 8 up to "
                         f"{MAX_DIM}, got {D}")
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"add_norm kernel writes bf16 or f32, not {out_dtype}")
    if (branch is None) != (gamma is None):
        raise ValueError("add_norm takes a branch and its gamma together")
    if branch is not None and (branch.shape != x.shape or branch.dtype != x.dtype
                               or not branch.is_contiguous()):
        raise ValueError("add_norm kernel needs a contiguous branch of x's shape and dtype")
    vectors = [x] + [t for t in (branch, gamma, weight, bias) if t is not None]
    for t in vectors:
        if t.device != x.device:
            raise ValueError(f"add_norm kernel needs every tensor on {x.device}, got {t.device}")
        if t.data_ptr() % 16:
            raise ValueError("add_norm kernel needs 16-byte aligned tensors")
    for t in (gamma, weight, bias):
        if t is not None and (t.dtype != torch.float32 or t.shape != (D,)
                              or not t.is_contiguous()):
            raise ValueError(f"add_norm kernel takes contiguous f32 ({D},) parameters")
    if records_grad(*vectors):
        raise ValueError("add_norm kernel is inference only; a forward that records "
                         "gradients takes add_norm_plain")


def add_norm(x, branch, gamma, weight, bias, eps: float, out_dtype: torch.dtype):
    """``(x_new, y)`` of one block boundary by the CUDA kernel: bf16 ``x``
    and ``branch``, f32 ``gamma``, ``weight`` and ``bias``, width a multiple
    of 8 up to 2,048, autograd not recording.  It raises on anything else;
    :func:`takes_kernel` says which boundaries call it.  Without a branch,
    ``x_new`` is ``x`` itself."""
    if not x.is_cuda:
        raise ValueError(f"add_norm kernel runs on CUDA tensors, got {x.device}")
    _check(x, branch, gamma, weight, bias, out_dtype)
    D = x.shape[-1]
    x_new = x if branch is None else torch.empty_like(x)
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if x.numel() == 0:
        return x_new, y

    # Without a branch, branch, gamma and x_new go as null pointers.
    launch("add_norm_launch", "add_norm", x, branch, gamma, weight, bias,
           None if branch is None else x_new, y, x.numel() // D, D, float(eps),
           int(out_dtype == torch.float32))
    return x_new, y
