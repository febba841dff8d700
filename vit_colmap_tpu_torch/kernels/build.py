"""Build the port's native libraries, load them, and launch the CUDA kernels.

Every ``csrc/*.cu`` source exposes its kernels behind ``extern "C"``
launchers that return a CUDA error code, so the shared library needs no
PyTorch headers and no ``libcuda`` (the attention and int8 matcher
launchers reach ``cuTensorMapEncodeTiled`` through the runtime's
entry-point query): :mod:`ctypes` binds it, and :func:`launch` calls it.

The build cache serves the host C++ libraries too (``kernels/host_build.py``).
A library is built at first use, into ``_build/<key>/`` beside the package
(listed in ``.gitignore``), where ``<key>`` (:func:`cache_key`) hashes the
sources and headers, the compiler flags and the compiler's ``--version``: a
later process with the same three loads it instead of building again.  Each
compiler run (:func:`start`, :func:`finish`) writes a pid-tagged temp file
that replaces its target only on success, and keeps its command and output
beside the target as a log, with which a failure raises.  The CUDA build is
one ``nvcc -c`` per source, all started together, then one link; each
source's log holds ``-Xptxas -v``'s registers, shared memory and spills
(``<source>.nvcc.log``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path

import torch

from vit_colmap_tpu_torch.kernels import count_launch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
LIBRARY_NAME = "libvit_colmap_kernels.so"
SOURCE_SUFFIXES = (".cu", ".cuh", ".cc", ".h")

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
    # x, branch, gamma, w, b, x_new, y, rows, dim, eps, out_f32, stream
    "add_norm_launch": [_P] * 7 + [_I] * 2 + [ctypes.c_float, _I, _P],
}


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin); the "
            "port's CUDA kernels are built from source at first use"
        )
    return nvcc


@functools.cache
def compiler_version(compiler: str) -> str:
    """``compiler --version``, run once per process."""
    return subprocess.run([compiler, "--version"], capture_output=True, text=True,
                          check=True).stdout


def cache_key(src_dir: Path, flags: list[str], version: str) -> str:
    """Hash of every source and header directly under ``src_dir``, the
    flags and the compiler's version text."""
    h = hashlib.sha256()
    for src in sorted(src_dir.iterdir()):
        if src.suffix in SOURCE_SUFFIXES:
            h.update(src.name.encode() + b"\0" + src.read_bytes() + b"\0")
    h.update("\0".join(flags).encode() + b"\0" + version.encode())
    return h.hexdigest()[:16]


@dataclass
class Job:
    """One compiler run that writes ``target`` (through ``tmp``) and keeps
    its command and output in ``log``."""

    target: Path
    log: Path
    tmp: Path
    cmd: list[str]
    proc: subprocess.Popen


def start(command, target: Path, log: Path) -> Job:
    """Start ``command(tmp)``, the compiler command line that writes a
    pid-tagged temp file ``tmp`` beside ``target``."""
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f".{target.stem}.{os.getpid()}{target.suffix}")
    cmd = command(tmp)
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return Job(target, log, tmp, cmd, proc)


def finish(jobs: list[Job]):
    """Wait for each of ``jobs`` in turn, keep its log and move its temp
    file onto its target, yielding the target; a failed run raises with its
    output and stops the runs not yet finished."""
    try:
        for job in jobs:
            output = job.proc.communicate()[0]
            job.log.write_text(" ".join(job.cmd) + "\n" + output)
            if job.proc.returncode != 0:
                job.tmp.unlink(missing_ok=True)
                raise RuntimeError(
                    f"{Path(job.cmd[0]).name} failed ({job.proc.returncode}) building "
                    f"{job.target.name}; log {job.log}:\n{output}")
            os.replace(job.tmp, job.target)  # atomic: concurrent processes never see half
            yield job.target
    finally:
        for job in jobs:
            if job.proc.poll() is None:
                job.proc.kill()
                job.proc.wait()


def cache_dir() -> Path:
    """The build directory of these sources, flags and compiler."""
    return BUILD_DIR / cache_key(CSRC_DIR, NVCC_FLAGS, compiler_version(find_nvcc()))


def log_path(source: str, out_dir: Path | None = None) -> Path:
    """Where :func:`build` keeps ``csrc/<source>``'s compiler output."""
    return (out_dir or cache_dir()) / f"{Path(source).stem}.nvcc.log"


def build(out_dir: Path) -> Path:
    """Compile every ``csrc/*.cu`` (one ``nvcc`` each, in parallel) and link
    them into one shared library; returns its path."""
    sources = sorted(CSRC_DIR.glob("*.cu"))
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    objects = [out_dir / f"{src.stem}.o" for src in sources]
    compiles = [
        start(lambda tmp, src=src: [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                                    str(tmp), str(src)],
              obj, log_path(src.name, out_dir))
        for src, obj in zip(sources, objects)]
    list(finish(compiles))
    link = start(lambda tmp: [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                              *map(str, objects)],
                 out_dir / LIBRARY_NAME, log_path(LIBRARY_NAME, out_dir))
    [target] = finish([link])
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


_library_lock = threading.Lock()


@functools.cache
def _bound_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(library_path()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def library() -> ctypes.CDLL:
    """The kernel library, built (or loaded) and bound with ctypes once per
    process; mesh slots that ask at once share one build."""
    with _library_lock:
        return _bound_library()


def launch(launcher: str, name: str, *args) -> None:
    """Call ``launcher`` of :data:`SIGNATURES` with ``args`` (each tensor
    as its data pointer) and the current stream of the first tensor's
    device, on that device; raise with the launcher's name if it returns a
    CUDA error, else count one launch of ``name`` in ``kernels.launches``."""
    device = next(a for a in args if isinstance(a, torch.Tensor)).device
    fn = getattr(library(), launcher)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args),
                 stream)
    if err != 0:
        raise RuntimeError(f"{launcher}: CUDA error {err} at launch")
    count_launch(name)
