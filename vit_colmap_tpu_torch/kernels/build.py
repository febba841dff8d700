"""Build the port's CUDA kernels with one ``nvcc`` call and load them.

Every ``csrc/*.cu`` source exposes its kernels behind ``extern "C"``
launchers that return a CUDA error code, so the shared library needs no
PyTorch headers: ``nvcc`` compiles it in seconds and :mod:`ctypes` binds it.
The library is built at first use in each process, into ``_build/`` beside
the package (listed in ``.gitignore``), and the build time is printed.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
LIBRARY_NAME = "libvit_colmap_kernels.so"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
# launcher name -> argument types; every launcher returns a cudaError_t.
SIGNATURES = {
    # qkv, out, batch, n, num_heads, q_scale, stream
    "attention_qkv_launch": [_P, _P, _I, _I, _I, ctypes.c_float, _P],
    # d1, d2, valid1, valid2, best, second, best_idx, col_val, col_row,
    # pairs, n, m, stream
    "match_topk2_colmax_launch": [_P] * 9 + [_I, _I, _I, _P],
}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin); the "
            "port's CUDA kernels are built from source at first use"
        )
    return nvcc


def build(out_dir: Path = BUILD_DIR) -> Path:
    """Compile every ``csrc/*.cu`` into one shared library; returns its path."""
    sources = sorted(str(p) for p in CSRC_DIR.glob("*.cu"))
    out_dir.mkdir(parents=True, exist_ok=True)
    target = out_dir / LIBRARY_NAME
    tmp = out_dir / f".{LIBRARY_NAME}.{os.getpid()}"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *sources]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, target)  # atomic: concurrent processes never see half
    print(
        f"[vit_colmap_tpu_torch] built {len(sources)} CUDA sources with one "
        f"nvcc call in {time.perf_counter() - t0:.1f} s -> {target}",
        flush=True,
    )
    return target


@functools.cache
def library() -> ctypes.CDLL:
    """The kernel library, built once per process and bound with ctypes."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
