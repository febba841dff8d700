"""The trainer's checkpoint directories.

The JAX package writes orbax directories; the port keeps their names
(``latest``, ``checkpoint_epoch_NNNN``, ``best_model``) and writes into each
one file, ``state.pt``: a ``torch.save`` of plain tensors --

* ``heads``: the heads' ``state_dict`` (GroupNorm heads,
  ``models/feature_model.FeatureHeads``);
* ``backbone``: the DINOv2 ``state_dict`` (public checkpoint keys), only
  under ``--train-backbone``;
* ``step`` and ``optimizer`` (AdamW's ``state_dict``): in ``latest`` and the
  epoch checkpoints, not in ``best_model``, which holds parameters only.

The file is written beside itself and renamed into place, so a directory
holds either the previous state or the new one.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import torch

CHECKPOINT_FILE = "state.pt"


def _cpu(state_dict: dict) -> dict:
    return {k: v.detach().cpu() for k, v in state_dict.items()}


def save_checkpoint(path: Path, heads: torch.nn.Module,
                    backbone: Optional[torch.nn.Module] = None,
                    train_state=None) -> Path:
    """Write ``path / state.pt``: the heads, the backbone when given, and
    the step and optimizer state of ``train_state`` when given."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    payload = {"heads": _cpu(heads.state_dict())}
    if backbone is not None:
        payload["backbone"] = _cpu(backbone.state_dict())
    if train_state is not None:
        payload.update(train_state.state_dict())
    target = path / CHECKPOINT_FILE
    tmp = path / (CHECKPOINT_FILE + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, target)
    return target


def load_checkpoint(path: Path) -> dict:
    """A checkpoint directory (or its ``state.pt``) -> its payload, tensors
    on the CPU."""
    path = Path(path)
    f = path / CHECKPOINT_FILE if path.is_dir() else path
    if not f.exists():
        raise FileNotFoundError(f"{path}: no {CHECKPOINT_FILE}; not a checkpoint of the trainer")
    return torch.load(f, map_location="cpu", weights_only=True)
