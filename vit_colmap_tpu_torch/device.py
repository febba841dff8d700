"""Device resolution for the port's entry points.

``device=None`` means ``"cuda"``: the port runs on the card unless the
caller asks for the CPU, where every kernel wrapper takes its plain
PyTorch version.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; the port runs on the GPU unless "
            "device='cpu' is passed explicitly"
        )
    return dev
