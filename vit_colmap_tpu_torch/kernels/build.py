"""Build the port's CUDA kernels with ``nvcc`` and load them.

Every ``csrc/*.cu`` source exposes its kernels behind ``extern "C"``
launchers that return a CUDA error code, so the shared library needs no
PyTorch headers and no ``libcuda`` (the attention and int8 matcher
launchers reach ``cuTensorMapEncodeTiled`` through the runtime's
entry-point query): :mod:`ctypes` binds it.  The library is
built at first use in each process, into ``_build/`` beside the package
(listed in ``.gitignore``):
one ``nvcc -c`` per source, all started together, then one link; the build
time is printed, and each source's compiler output (``-Xptxas -v``:
registers, shared memory and spills of every kernel) is kept beside the
library as ``<source>.nvcc.log``.
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
# launcher name -> argument types; every launcher returns a cudaError_t.
SIGNATURES = {
    # q, k, v, out, batch, heads, n, d, strides (int64[12]), q_scale,
    # elem_bytes (2: bf16, 4: f32), stream
    "fixed_max_attention_launch": [_P] * 4 + [_I] * 4
    + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, _I, _P],
    # d1, d2, valid1, valid2, best, second, best_idx, col_val, col_row,
    # pairs, n, m, dim, stream
    "match_topk2_colmax_launch": [_P] * 9 + [_I] * 4 + [_P],
    # d1, d2, valid2, best, second, best_idx, pairs, n, m, dim, stream
    "match_topk2_launch": [_P] * 6 + [_I] * 4 + [_P],
    # a1, a2, s1, s2, inv1, inv2, coef, best, second, best_idx, pairs, n, m,
    # dim, stream
    "match_topk2_int8_launch": [_P] * 10 + [_I] * 4 + [_P],
}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin); the "
            "port's CUDA kernels are built from source at first use"
        )
    return nvcc


def _run(cmd: list[str]) -> subprocess.Popen:
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _finish(proc: subprocess.Popen, cmd: list[str]) -> str:
    output = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{output}")
    return output


def log_path(source: str, out_dir: Path = BUILD_DIR) -> Path:
    """Where :func:`build` keeps ``csrc/<source>``'s compiler output."""
    return out_dir / f"{Path(source).stem}.nvcc.log"


def build(out_dir: Path = BUILD_DIR) -> Path:
    """Compile every ``csrc/*.cu`` (one ``nvcc`` each, in parallel) and link
    them into one shared library; returns its path."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    out_dir.mkdir(parents=True, exist_ok=True)
    target = out_dir / LIBRARY_NAME
    tag = str(os.getpid())
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    objects = [out_dir / f".{src.stem}.{tag}.o" for src in sources]
    compiles = [[nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(obj), str(src)]
                for src, obj in zip(sources, objects)]
    procs = [_run(cmd) for cmd in compiles]
    try:
        for src, proc, cmd in zip(sources, procs, compiles):
            log_path(src.name, out_dir).write_text(_finish(proc, cmd))
    finally:  # a failed source stops the others
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    tmp = out_dir / f".{LIBRARY_NAME}.{tag}"
    link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objects)]
    _finish(_run(link), link)
    for obj in objects:
        obj.unlink()
    os.replace(tmp, target)  # atomic: concurrent processes never see half
    print(
        f"[vit_colmap_tpu_torch] built {len(sources)} CUDA sources with "
        f"{len(sources)} parallel nvcc calls and one link in "
        f"{time.perf_counter() - t0:.1f} s -> {target}",
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
