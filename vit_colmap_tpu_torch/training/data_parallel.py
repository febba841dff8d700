"""The trainer's data parallelism over a mesh's slots.

Counterpart of the JAX trainer's mesh (``vit_colmap_tpu/training/
train.py``: ``gcd(batch, devices)`` devices, the batch sharded over
``data``, the state replicated).  Under ``jit`` the JAX step sees the global
batch, so the three terms of the loss that depend on the whole batch (the
detector loss's ``pos_weight`` and cell normalisation, the variance hinge
over every anchor, the cross-image negatives that roll the batch by one)
are computed as on one device.  DDP's per-rank loss averaged over ranks
would compute none of them so.  Here only the forward passes of the
backbone and the heads are split: :class:`SlotForward` runs each slot's
share through a replica whose trainable parameters are differentiable
``.to(slot)`` copies of the one master copy (``torch.func.functional_call``;
frozen parameters are copied to each device once), and gathers the outputs
on the first slot's device, where sampling, the negatives and the loss run
over the global batch as on one device.  Gradients flow back through the
copies to the master parameters.
"""

from __future__ import annotations

import math
import threading
from typing import Optional, Sequence

import torch
from torch.func import functional_call

from vit_colmap_tpu_torch.parallel.mesh import (
    gather,
    get_mesh,
    replicate_module,
    run_slots,
    shard_batch,
)


def data_slots(batch_size: int, devices: Sequence[torch.device]) -> list[torch.device]:
    """The slots a batch of ``batch_size`` is split over: the first
    ``gcd(batch_size, len(devices))`` devices, so the data axis divides the
    batch (batch 2 over 8 devices takes 2)."""
    return list(devices[: math.gcd(batch_size, len(devices))])


class SlotForward:
    """``module`` over ``devices``: a batch-leading input split into equal
    contiguous shares, one a slot, each run on its slot's device and thread,
    the outputs gathered on ``devices[0]`` (where ``module`` lives).  A slot
    on ``module``'s device calls ``module`` itself.  A slot on another
    device calls that device's replica (:func:`parallel.mesh.
    replicate_module`, made at the first call, so after any weights were
    loaded): the parameters that require grad are copied to the device at
    each call (``torch.func.functional_call``), so the master receives their
    gradients; frozen parameters and buffers are the replica's own, copied
    once.  One slot runs inline."""

    def __init__(self, module: torch.nn.Module, devices: Sequence[torch.device]):
        self.module = module
        self.mesh = get_mesh(devices)
        self.devices = self.mesh.data_devices
        self._replicas: Optional[list] = None
        # functional_call swaps a replica's tensors in place: slots that
        # share a replica take turns.
        self._locks: dict[int, threading.Lock] = {}

    def __call__(self, x: torch.Tensor):
        if self._replicas is None:
            self._replicas = replicate_module(self.module, self.devices)
            self._locks = {id(r): threading.Lock() for r in self._replicas}
        trainable = {k: p for k, p in self.module.named_parameters() if p.requires_grad}

        def body(i, share):
            replica = self._replicas[i]
            if replica is self.module or not trainable:
                return replica(share)
            dev = self.devices[i]
            with self._locks[id(replica)]:
                return functional_call(replica, {k: p.to(dev) for k, p in trainable.items()},
                                       (share,))

        return gather(run_slots(body, self.devices, shard_batch(x, self.mesh)), self.devices[0])
