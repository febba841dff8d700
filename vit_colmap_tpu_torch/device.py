"""Device resolution for the port's entry points, and exact f32
convolutions and matmuls.

``device=None`` means ``"cuda"``: the port runs on the card unless the
caller asks for the CPU, where every kernel wrapper takes its plain
PyTorch version.
"""

from __future__ import annotations

import contextlib
import threading
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


class _FlagOff:
    """A global backend flag held False while any thread is inside one of
    its blocks, and the setting from before the first of them put back when
    the last one leaves.  Mesh slots run on several threads at once: a
    block that put back its own entry value while another thread was still
    inside would let that thread's work run in TF32."""

    def __init__(self, get, set_):
        self._get, self._set = get, set_
        self._lock = threading.Lock()
        self._depth = 0
        self._previous = None

    @contextlib.contextmanager
    def __call__(self) -> Iterator[None]:
        with self._lock:
            if self._depth == 0:
                self._previous = self._get()
                self._set(False)
            self._depth += 1
        try:
            yield
        finally:
            with self._lock:
                self._depth -= 1
                if self._depth == 0:
                    self._set(self._previous)


def _set_cudnn_tf32(v: bool) -> None:
    torch.backends.cudnn.allow_tf32 = v


def _set_matmul_tf32(v: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = v


_cudnn_tf32_off = _FlagOff(lambda: torch.backends.cudnn.allow_tf32, _set_cudnn_tf32)
_matmul_tf32_off = _FlagOff(lambda: torch.backends.cuda.matmul.allow_tf32, _set_matmul_tf32)


def exact_f32_convolutions():
    """cuDNN convolutions in full f32 for the duration of the block, and
    the caller's setting back afterwards.

    PyTorch lets cuDNN run f32 convolutions in TF32 by default
    (``torch.backends.cudnn.allow_tf32``), which keeps 10 mantissa bits; the
    reference computes them in f32.  The port's f32 convolutions (the
    saliency blurs, the f32 patch embedding) run inside this block so that
    they do not depend on the global flag."""
    return _cudnn_tf32_off()


def exact_f32_matmuls():
    """cuBLAS f32 matmuls in full f32 (no TF32) for the duration of the
    block, and the caller's setting back afterwards.

    Two-view verification's fits (``ops/ransac.py``) are f32 like the
    reference's; a caller's ``torch.backends.cuda.matmul.allow_tf32 =
    True`` (or ``torch.set_float32_matmul_precision("high")``) would
    otherwise run their batched products with 10 mantissa bits."""
    return _matmul_tf32_off()
