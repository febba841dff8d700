"""Device resolution for the port's entry points, and exact f32
convolutions and matmuls.

``device=None`` means ``"cuda"``: the port runs on the card unless the
caller asks for the CPU, where every kernel wrapper takes its plain
PyTorch version.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; the port runs on the GPU unless "
            "device='cpu' is passed explicitly"
        )
    return dev


@contextlib.contextmanager
def exact_f32_convolutions() -> Iterator[None]:
    """cuDNN convolutions in full f32 for the duration of the block, and
    the caller's setting back afterwards.

    PyTorch lets cuDNN run f32 convolutions in TF32 by default
    (``torch.backends.cudnn.allow_tf32``), which keeps 10 mantissa bits; the
    reference computes them in f32.  The port's f32 convolutions (the
    saliency blurs, the f32 patch embedding) run inside this block so that
    they do not depend on the global flag."""
    previous = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = previous


@contextlib.contextmanager
def exact_f32_matmuls() -> Iterator[None]:
    """cuBLAS f32 matmuls in full f32 (no TF32) for the duration of the
    block, and the caller's setting back afterwards.

    Two-view verification's fits (``ops/ransac.py``) are f32 like the
    reference's; a caller's ``torch.backends.cuda.matmul.allow_tf32 =
    True`` (or ``torch.set_float32_matmul_precision("high")``) would
    otherwise run their batched products with 10 mantissa bits."""
    previous = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = previous
