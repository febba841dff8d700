"""The run's environment: build and kernel caches at fixed paths inside the
checkout, few host threads, no JAX, and what the machine says about the
card and the process.

``prepare`` runs before torch is imported, so that every cache variable is
read from here.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

# Top-level module names that may not be loaded in a run: JAX, its runtime,
# flax, and the JAX package of this repository.  Compared whole, so that the
# port (``vit_colmap_tpu_torch``) does not match.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "vit_colmap_tpu")

CACHE_DIR = ".bench_cache"  # under the checkout's root; listed in .gitignore
HOST_THREADS = "4"


def prepare(root: Path) -> None:
    """Fix every cache directory to a path inside the checkout and keep the
    host's thread pools small.  The port builds its CUDA and host libraries
    into ``vit_colmap_tpu_torch/_build/``, which is inside the checkout too."""
    cache = root / CACHE_DIR
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = HOST_THREADS


def cache_bytecode(root: Path) -> None:
    """Write and read the bytecode of every module imported from here on
    under the checkout's cache (``<cache>/pycache``), also where the
    environment turns bytecode writing off: compiling torch's sources anew
    took about half of each run's ``import torch``."""
    sys.pycache_prefix = str(root / CACHE_DIR / "pycache")
    sys.dont_write_bytecode = False


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_loaded(modules=None) -> list[str]:
    """Names in ``sys.modules`` (or ``modules``) whose top-level name is one
    of ``FORBIDDEN_MODULES``."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if top_level(n) in FORBIDDEN_MODULES)


def io_counts() -> dict:
    """This process's ``/proc/self/io``: ``wchar`` (bytes it passed to write
    calls) and ``write_bytes`` (bytes it caused to reach storage); empty
    where it cannot be read."""
    try:
        lines = Path("/proc/self/io").read_text().splitlines()
    except OSError:
        return {}
    return {k: int(v) for k, v in (line.split(":") for line in lines)
            if k in ("wchar", "write_bytes")}


def nvidia_smi() -> str:
    """The card's name, power limit, SM clock and power draw, as
    ``nvidia-smi`` reads them; "not read" where it is missing."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,power.draw",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=False)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return out.stdout.strip() or "not read"
