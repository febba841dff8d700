"""Build the port's host C++ libraries with ``g++`` and load them.

The sources under ``csrc/host/`` are host code (no CUDA kernel): the
batched COLMAP-database writer (``libvc_db_writer.so``, bound by
``database/native.py``) and the image decoder (``libvc_image_io.so``,
bound by ``utils/native_io.py``).  Each is built at first use, never at
import, with ``g++ -O3 -shared -fPIC -std=c++17 -pthread`` into
``_build/<key>/`` beside the package (listed in ``.gitignore``), where
``<key>`` hashes every source and header under ``csrc/host/``, the whole
command line and ``g++ --version``; a later process with the same three
loads the library instead of building it again.  The compiler's output is
kept beside the library as ``lib<name>.g++.log``, and a compile error
raises with it.

The sources declare the C API they call, so only runtime libraries are
needed, linked by soname from the directory that holds them (as the JAX
package's ``native/build.sh`` does): ``libsqlite3.so.0`` for the writer;
``libz.so.1`` (PNG) and a JPEG codec for the decoder: ``libjpeg.so.62``
where it exists (``csrc/host/jpeg_libjpeg.cc``), otherwise nvJPEG from the
CUDA toolkit (``libnvjpeg.so.12`` and ``libcudart.so.12``, with the
toolkit's ``nvjpeg.h``; ``csrc/host/jpeg_nvjpeg.cc``), which finishes its
planes with libjpeg's upsampling and colour conversion
(``csrc/host/jpeg_color.cc``, built with either codec).  Where ``g++`` or a
runtime library is absent, :func:`load` raises :class:`Unavailable` with
the reason; the bindings then return ``None`` and their callers fall back
to the Python paths.
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

from vit_colmap_tpu_torch.kernels.build import BUILD_DIR, CSRC_DIR

HOST_DIR = CSRC_DIR / "host"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]
LIBRARIES = ("db_writer", "image_io")


class Unavailable(RuntimeError):
    """The compiler or a runtime library the host code links is absent."""


def find_gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise Unavailable("g++ not found on PATH")
    return gxx


@functools.cache
def gxx_version(gxx: str) -> str:
    return subprocess.run([gxx, "--version"], capture_output=True, text=True,
                          check=True).stdout


def cuda_home() -> Path:
    return Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda")


@functools.cache
def ldconfig_paths() -> dict[str, str]:
    """soname -> path, from ``ldconfig -p`` (empty where it is missing)."""
    ldconfig = shutil.which("ldconfig") or "/sbin/ldconfig"
    try:
        out = subprocess.run([ldconfig, "-p"], capture_output=True, text=True,
                             check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return {}
    paths = {}
    for line in out.splitlines()[1:]:
        name, _, path = line.strip().partition(" => ")
        soname = name.split(" (")[0]
        if "x86-64" in name or "(libc6)" in name:
            paths.setdefault(soname, path)
    return paths


def find_soname(soname: str) -> Path | None:
    """The file of a runtime library, from ldconfig's cache."""
    path = ldconfig_paths().get(soname)
    return None if path is None else Path(path)


def _link(sonames: list[str]) -> list[str]:
    """-L, -l: and rpath flags that link each soname from its directory."""
    flags = []
    for soname in sonames:
        path = find_soname(soname)
        if path is None:
            raise Unavailable(f"runtime library {soname} not found")
        flags += [f"-L{path.parent}", f"-l:{soname}", f"-Wl,-rpath,{path.parent}"]
    return flags


def jpeg_codec() -> str:
    """"libjpeg" where libjpeg.so.62 exists, else "nvjpeg" where the CUDA
    toolkit's nvJPEG does; raises :class:`Unavailable` otherwise."""
    if find_soname("libjpeg.so.62") is not None:
        return "libjpeg"
    if (find_soname("libnvjpeg.so.12") is not None
            and (cuda_home() / "include" / "nvjpeg.h").exists()):
        return "nvjpeg"
    raise Unavailable("no JPEG runtime: neither libjpeg.so.62 nor nvJPEG "
                      "(libnvjpeg.so.12 with the CUDA toolkit's nvjpeg.h)")


def sources_and_flags(name: str) -> tuple[list[Path], list[str]]:
    """The sources of library ``name`` and its compile and link flags."""
    if name == "db_writer":
        return [HOST_DIR / "db_writer.cc"], _link(["libsqlite3.so.0"])
    if name == "image_io":
        common = [HOST_DIR / "image_io.cc", HOST_DIR / "jpeg_color.cc"]
        if jpeg_codec() == "libjpeg":
            return (common + [HOST_DIR / "jpeg_libjpeg.cc"],
                    _link(["libz.so.1", "libjpeg.so.62"]))
        return (common + [HOST_DIR / "jpeg_nvjpeg.cc"],
                [f"-I{cuda_home() / 'include'}"]
                + _link(["libz.so.1", "libnvjpeg.so.12", "libcudart.so.12"]))
    raise ValueError(f"unknown host library {name!r}")


def library_name(name: str) -> str:
    return f"libvc_{name}.so"


def cache_key(host_dir: Path, flags: list[str], version: str) -> str:
    """Hash of every source and header under ``host_dir``, the flags and
    the compiler's version text."""
    h = hashlib.sha256()
    for src in sorted(host_dir.iterdir()):
        if src.suffix in (".cc", ".h"):
            h.update(src.name.encode() + b"\0" + src.read_bytes() + b"\0")
    h.update("\0".join(flags).encode() + b"\0" + version.encode())
    return h.hexdigest()[:16]


def _command(name: str, target: Path) -> list[str]:
    sources, flags = sources_and_flags(name)
    return [find_gxx(), *GXX_FLAGS, "-o", str(target), *map(str, sources), *flags]


def target_path(name: str) -> Path:
    """Where library ``name`` of these sources, flags and compiler lives."""
    gxx = find_gxx()
    flags = _command(name, Path(library_name(name)))[1:]
    return BUILD_DIR / cache_key(HOST_DIR, flags, gxx_version(gxx)) / library_name(name)


def log_path(target: Path) -> Path:
    return target.with_name(target.name.replace(".so", ".g++.log"))


def _start(name: str, target: Path):
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f".{target.name}.{os.getpid()}")
    cmd = _command(name, tmp)
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, cmd, tmp


def _finish(proc, cmd: list[str], tmp: Path, target: Path) -> None:
    output = proc.communicate()[0]
    log_path(target).write_text(" ".join(cmd) + "\n" + output)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}) building "
                           f"{target.name}; log {log_path(target)}:\n{output}")
    os.replace(tmp, target)  # atomic: concurrent processes never see half


def build_all(names=LIBRARIES, force: bool = False) -> dict[str, float]:
    """Build every library of ``names`` not built yet (every one with
    ``force``), one g++ each, all started together; returns each build's
    seconds (0 for a cached one)."""
    started, seconds = [], {}
    t0 = time.perf_counter()
    for name in names:
        target = target_path(name)
        seconds[name] = 0.0
        if force or not target.exists():
            started.append((name, target, *_start(name, target)))
    for name, target, proc, cmd, tmp in started:
        _finish(proc, cmd, tmp, target)
        seconds[name] = time.perf_counter() - t0
        print(f"[vit_colmap_tpu_torch] built {target.name} with g++ in "
              f"{seconds[name]:.1f} s -> {target}", flush=True)
    return seconds


def library_path(name: str) -> Path:
    """Library ``name``: the one a process built before, or a new build."""
    target = target_path(name)
    if not target.exists():
        build_all([name])
    return target


def load(name: str) -> ctypes.CDLL:
    """Library ``name`` bound with ctypes (its callers declare argtypes)."""
    return ctypes.CDLL(str(library_path(name)))
