"""Several processes: the ``torch.distributed`` seam.

Counterpart of ``vit_colmap_tpu/parallel/multihost.py``:

* :func:`initialize` joins a process group when a multi-process
  environment is configured (a no-op returning False for one process, and
  safe to call twice; :func:`shutdown` leaves the group).  It reads the same ``COORDINATOR_ADDRESS``
  (``host:port``) / ``NUM_PROCESSES`` / ``PROCESS_ID`` variables when its
  arguments are omitted, and calls ``init_process_group`` with
  ``tcp://<address>``, the world size and the rank: NCCL where CUDA is
  present, gloo on the CPU.  Each process takes card ``rank %
  device_count``.
* :func:`local_image_slice` is each process's data-loading plan: its
  contiguous share of the image list (a ceil split), so decode and host
  memory scale out with processes while the mapper and the database stay
  with process 0 (:func:`is_primary`).

A process's mesh (``parallel/mesh.py``) holds its own devices only; what
crosses processes goes through ``torch.distributed`` collectives.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Sequence

import torch

logger = logging.getLogger(__name__)

_initialized = False


def _dist():
    import torch.distributed as dist

    return dist


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Join the process group when several processes are configured.

    Returns True when running multi-process (after initialization), False
    for plain single-process runs.  Safe to call multiple times."""
    global _initialized
    dist = _dist()
    if _initialized or (dist.is_available() and dist.is_initialized()):
        _initialized = True
        return dist.is_initialized() and dist.get_world_size() > 1

    coordinator_address = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if num_processes is None and "NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["NUM_PROCESSES"])
    if process_id is None and "PROCESS_ID" in os.environ:
        process_id = int(os.environ["PROCESS_ID"])

    if coordinator_address is None and num_processes in (None, 1):
        _initialized = True  # one process: nothing to coordinate
        return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "a multi-process run needs COORDINATOR_ADDRESS, NUM_PROCESSES and "
            f"PROCESS_ID (got {coordinator_address!r}, {num_processes!r}, {process_id!r})"
        )

    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    address = coordinator_address
    if "://" not in address:
        address = f"tcp://{address}"
    dist.init_process_group(
        backend="nccl" if cuda else "gloo",
        init_method=address,
        world_size=num_processes,
        rank=process_id,
    )
    _initialized = True
    logger.info(
        "Multi-process initialized: process %d/%d over %s, %s",
        dist.get_rank(), dist.get_world_size(), dist.get_backend(),
        f"card {torch.cuda.current_device()}" if cuda else "CPU",
    )
    return num_processes > 1


def shutdown() -> None:
    """Leave the process group (if any); :func:`initialize` may join again."""
    global _initialized
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _initialized = False


def process_index() -> int:
    dist = _dist()
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    dist = _dist()
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the process that should own host-side side effects (DB
    writes, checkpoint metadata, logging)."""
    return process_index() == 0


def local_image_slice(paths: Sequence, *, batch: int = 1) -> list:
    """This process's contiguous share of ``paths`` (``ceil(n / processes)``
    each, the last one shorter); the whole list for one process.
    Contiguous runs keep the database's insertion order deterministic when
    process 0 concatenates the results.  ``batch`` is accepted for the JAX
    package's signature; the caller pads its batches."""
    n_proc = process_count()
    if n_proc == 1:
        return list(paths)
    pid = process_index()
    per = -(-len(paths) // n_proc)  # ceil
    return list(paths[pid * per:(pid + 1) * per])
