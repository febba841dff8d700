"""Build the port's CUDA kernels with ``nvcc`` and load them.

Every ``csrc/*.cu`` source exposes its kernels behind ``extern "C"``
launchers that return a CUDA error code, so the shared library needs no
PyTorch headers and no ``libcuda`` (the attention and int8 matcher
launchers reach ``cuTensorMapEncodeTiled`` through the runtime's
entry-point query): :mod:`ctypes` binds it.  The library is
built at first use, into ``_build/<key>/`` beside the package (listed in
``.gitignore``), where ``<key>`` hashes the sources, ``NVCC_FLAGS`` and
``nvcc --version``: a later process with the same three loads it instead
of building again.  A build is one ``nvcc -c`` per source, all started
together, then one link; the build time is printed, and each source's
compiler output (``-Xptxas -v``: registers, shared memory and spills of
every kernel) is kept beside the library as ``<source>.nvcc.log``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
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


def nvcc_version(nvcc: str) -> str:
    return subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                          check=True).stdout


def cache_key(csrc_dir: Path, flags: list[str], version: str) -> str:
    """Hash of every source and header under ``csrc_dir``, the flags and
    the compiler's version text."""
    h = hashlib.sha256()
    for src in sorted(csrc_dir.iterdir()):
        if src.suffix in (".cu", ".cuh"):
            h.update(src.name.encode() + b"\0" + src.read_bytes() + b"\0")
    h.update("\0".join(flags).encode() + b"\0" + version.encode())
    return h.hexdigest()[:16]


def cache_dir() -> Path:
    """The build directory of these sources, flags and compiler."""
    return BUILD_DIR / cache_key(CSRC_DIR, NVCC_FLAGS, nvcc_version(find_nvcc()))


def log_path(source: str, out_dir: Path | None = None) -> Path:
    """Where :func:`build` keeps ``csrc/<source>``'s compiler output."""
    return (out_dir or cache_dir()) / f"{Path(source).stem}.nvcc.log"


def build(out_dir: Path) -> Path:
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


def library_path() -> Path:
    """The library of these sources, flags and compiler: the one a process
    built before, or a new build."""
    out_dir = cache_dir()
    target = out_dir / LIBRARY_NAME
    if target.exists():
        print(f"[vit_colmap_tpu_torch] loading the cached build {target}", flush=True)
        return target
    return build(out_dir)


@functools.cache
def library() -> ctypes.CDLL:
    """The kernel library, bound with ctypes once per process."""
    lib = ctypes.CDLL(str(library_path()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
