"""Build the port's host C++ libraries with ``g++`` and load them.

The sources under ``csrc/host/`` are host code (no CUDA kernel): the
batched COLMAP-database writer (``libvc_db_writer.so``, bound by
``database/native.py``) and the image decoder (``libvc_image_io.so``,
bound by ``utils/native_io.py``).  Each is built at first use, never at
import, with ``g++ -O3 -shared -fPIC -std=c++17 -pthread``, through the
build cache of ``kernels/build.py``: into ``_build/<key>/``, where ``<key>``
hashes every source and header under ``csrc/host/``, the whole command line
and ``g++ --version``.  The compiler's output is kept beside the library as
``lib<name>.g++.log``, and a compile error raises with it.

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
import os
import shutil
import subprocess
import time
from pathlib import Path

from vit_colmap_tpu_torch.kernels import build
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


def _command(name: str, out: Path) -> list[str]:
    sources, flags = sources_and_flags(name)
    return [find_gxx(), *GXX_FLAGS, "-o", str(out), *map(str, sources), *flags]


def target_path(name: str) -> Path:
    """Where library ``name`` of these sources, flags and compiler lives."""
    cmd = _command(name, Path(library_name(name)))
    key = build.cache_key(HOST_DIR, cmd[1:], build.compiler_version(cmd[0]))
    return BUILD_DIR / key / library_name(name)


def log_path(target: Path) -> Path:
    return target.with_name(target.name.replace(".so", ".g++.log"))


def build_all(names=LIBRARIES, force: bool = False) -> dict[str, float]:
    """Build every library of ``names`` not built yet (every one with
    ``force``), one g++ each, all started together; returns each build's
    seconds (0 for a cached one)."""
    seconds = dict.fromkeys(names, 0.0)
    t0 = time.perf_counter()
    targets = {name: target_path(name) for name in names}
    jobs = {name: build.start(functools.partial(_command, name), t, log_path(t))
            for name, t in targets.items() if force or not t.exists()}
    for name, target in zip(jobs, build.finish(list(jobs.values()))):
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
