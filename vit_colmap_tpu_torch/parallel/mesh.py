"""Device meshes: one process driving several devices.

Counterpart of ``vit_colmap_tpu/parallel/mesh.py``.  The JAX package runs
one controller over every device it sees: under ``jit`` a program sees the
global batch, and sharding changes where the work runs, not what is
computed.  The port keeps that model:

* a :class:`Mesh` is a (data, model) array of ``torch.device``s in this
  process (a device may repeat: several slots on the CPU, or two slots on
  one card);
* each data slot's share of a batch runs on its own device, one thread a
  slot (:func:`run_slots`, in the manner of
  ``torch.nn.parallel.parallel_apply``), so that one slot's host syncs do
  not hold up the others; outputs come back in slot order;
* whatever needs the whole batch (a PCA fit, a loss over the batch) runs
  once, on the first slot's device, over the gathered outputs.

Uses: images are data-parallel for extraction, pair batches for matching
(descriptors replicated, or sharded over images with a gather a batch), and
the trainer's forward is data-parallel with its loss over the global batch.
``torch.distributed`` carries only the process seam (``multihost.py``).
The ``model`` axis is reserved, as in the JAX package.
"""

from __future__ import annotations

import contextlib
import copy
import threading
from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Union

import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"

DeviceLike = Union[str, torch.device]


@dataclass(frozen=True)
class Mesh:
    """A (data, model) array of devices; ``devices[i][j]`` is data slot i,
    model slot j."""

    devices: tuple[tuple[torch.device, ...], ...]
    axis_names: tuple[str, str] = (DATA_AXIS, MODEL_AXIS)

    @property
    def shape(self) -> dict[str, int]:
        return {DATA_AXIS: len(self.devices), MODEL_AXIS: len(self.devices[0])}

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])

    @property
    def data_devices(self) -> list[torch.device]:
        """The device of each data slot (its first model slot), in order."""
        return [row[0] for row in self.devices]


def get_mesh(
    devices: Optional[Sequence[DeviceLike]] = None,
    data: Optional[int] = None,
    model: int = 1,
) -> Mesh:
    """A (data, model) mesh over ``devices`` (default: every visible card;
    raises without one, as ``device.resolve_device`` does).  A device may
    appear more than once."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if not devices:
            raise RuntimeError(
                "CUDA is not available; pass devices (e.g. ['cpu'] * 8) to "
                "build a mesh on the CPU"
            )
    devs = [_indexed(torch.device(d)) for d in devices]
    n = len(devs)
    if data is None:
        data = n // model
    if data * model != n or n == 0:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    rows = tuple(tuple(devs[i * model:(i + 1) * model]) for i in range(data))
    return Mesh(rows)


def _indexed(device: torch.device) -> torch.device:
    """``cuda`` -> ``cuda:<current>``, so that slots compare equal to the
    devices their tensors report."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def resolve_mesh(device: torch.device) -> Mesh:
    """The mesh an entry point takes for ``device``: every visible card when
    there is more than one and the device names no index (``"cuda"``), as
    the JAX package shards when ``jax.device_count() > 1``; otherwise one
    slot on ``device``."""
    if device.type == "cuda" and device.index is None and torch.cuda.device_count() > 1:
        return get_mesh()
    return get_mesh([device])


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def split_sizes(n: int, mesh: Mesh) -> list[int]:
    """Rows of each data slot for a batch of ``n``; raises unless the data
    axis divides it, as a ``NamedSharding`` over ``data`` would."""
    ndev = mesh.shape[DATA_AXIS]
    if n % ndev:
        raise ValueError(f"batch {n} does not divide over {ndev} data slots")
    return [n // ndev] * ndev


def shard_batch(x: torch.Tensor, mesh: Mesh) -> list[torch.Tensor]:
    """A batch-leading tensor as contiguous slices, one on each data slot's
    device."""
    parts = torch.split(x, split_sizes(x.shape[0], mesh))
    return [p.to(d) for p, d in zip(parts, mesh.data_devices)]


def replicate(x: torch.Tensor, mesh: Mesh) -> list[torch.Tensor]:
    """One copy of ``x`` on each data slot's device (slots that share a
    device share the tensor)."""
    return [x.to(d) for d in mesh.data_devices]


def gather(parts: Sequence, device: DeviceLike):
    """The slots' outputs concatenated in slot order on ``device``: tensors,
    or tuples or dicts of batch-leading tensors (a dict's other values, such
    as the backbone's ``grid``, are the first slot's).  One slot's output is
    only moved, not copied."""
    first = parts[0]
    if isinstance(first, torch.Tensor):
        if len(parts) == 1:
            return first.to(device)
        return torch.cat([p.to(device) for p in parts])
    if isinstance(first, tuple):
        return tuple(gather([p[k] for p in parts], device) for k in range(len(first)))
    return {k: gather([p[k] for p in parts], device) if isinstance(v, torch.Tensor) else v
            for k, v in first.items()}


def replicate_module(module: torch.nn.Module, devices: Sequence[torch.device]) -> list:
    """One module a slot for forward passes without gradients: ``module``
    itself on the devices it lives on, one copy for each other device
    (made once; later changes to ``module`` do not reach the copies)."""
    home = next(module.parameters()).device
    copies: dict[torch.device, torch.nn.Module] = {home: module}
    for d in devices:
        if d not in copies:
            copies[d] = copy.deepcopy(module).to(d)
    return [copies[d] for d in devices]


def _device_context(device: torch.device):
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def run_slots(fn: Callable, devices: Sequence[torch.device], *per_slot: Sequence) -> list:
    """``[fn(i, *args_i) for each slot i]``, each call on its own thread
    under its slot's device and that device's current stream (the caller's,
    so cuBLAS sees one stream as in a one-device run), with the caller's
    grad mode; results in slot order.  One slot runs on the calling thread.
    The first exception of a slot is raised after every thread has ended."""
    n = len(devices)
    if n == 1:
        with _device_context(devices[0]):
            return [fn(0, *(a[0] for a in per_slot))]
    grad = torch.is_grad_enabled()
    streams = [torch.cuda.current_stream(d) if d.type == "cuda" else None for d in devices]
    results: list = [None] * n
    errors: list = [None] * n

    def worker(i: int) -> None:
        try:
            with torch.set_grad_enabled(grad), _device_context(devices[i]):
                stream = (torch.cuda.stream(streams[i]) if streams[i] is not None
                          else contextlib.nullcontext())
                with stream:
                    results[i] = fn(i, *(a[i] for a in per_slot))
        except BaseException as e:  # re-raised on the calling thread
            errors[i] = e

    threads = [threading.Thread(target=worker, args=(i,), name=f"slot{i}") for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for e in errors:
        if e is not None:
            raise e
    return results
