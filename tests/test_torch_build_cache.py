"""The native build cache and the kernels' launch path: the key hashes the
sources and headers, the compiler flags and the compiler's version, for the
CUDA library and the host libraries alike; a library built for a key is
loaded, not built again (no nvcc here: the build is replaced by a stand-in
that writes the file); and a launch raises on a CUDA error and counts only
the launches that succeed (a fake library stands in for the card)."""

import contextlib
import shutil

import pytest
import torch

from vit_colmap_tpu_torch.kernels import build, host_build, launches


@pytest.fixture
def csrc(tmp_path):
    d = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, d)
    return d


@pytest.mark.parametrize("src_dir,flags,version,header,source", [
    pytest.param(build.CSRC_DIR, build.NVCC_FLAGS, "nvcc 12.4", "hopper.cuh",
                 "match_topk2.cu", id="nvcc"),
    pytest.param(host_build.HOST_DIR, host_build.GXX_FLAGS + ["-l:libsqlite3.so.0"],
                 "g++ 12.2", "jpeg_backend.h", "db_writer.cc", id="g++"),
])
def test_key_covers_sources_headers_flags_and_compiler(src_dir, flags, version, header,
                                                       source, tmp_path):
    d = tmp_path / "src"
    shutil.copytree(src_dir, d)
    key = build.cache_key(d, flags, version)
    assert key == build.cache_key(d, list(flags), version) and len(key) == 16
    assert build.cache_key(d, flags, version + ".1") != key
    assert build.cache_key(d, flags + ["-g"], version) != key
    (d / header).write_text((d / header).read_text() + "\n")
    edited = build.cache_key(d, flags, version)
    assert edited != key
    (d / "notes.txt").write_text("not a source")
    assert build.cache_key(d, flags, version) == edited
    (d / source).rename(d / f"renamed{(d / source).suffix}")
    assert build.cache_key(d, flags, version) != edited


def test_library_path_builds_once_per_key(csrc, tmp_path, monkeypatch):
    builds = []

    def fake_build(out_dir):
        builds.append(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / build.LIBRARY_NAME).write_bytes(b"\0")
        return out_dir / build.LIBRARY_NAME

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    monkeypatch.setattr(build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build, "compiler_version", lambda compiler: "nvcc 12.4")
    monkeypatch.setattr(build, "build", fake_build)
    first = build.library_path()
    assert build.library_path() == first and len(builds) == 1
    assert first.parent.parent == tmp_path / "_build"
    assert build.log_path("match_topk2.cu") == first.parent / "match_topk2.nvcc.log"
    next(csrc.glob("*.cu")).write_text("// edited\n")
    second = build.library_path()
    assert second != first and len(builds) == 2 and first.exists()


class _FakeLauncher:
    def __init__(self, errors):
        self.errors, self.calls = list(errors), []

    def __call__(self, *args):
        self.calls.append(args)
        return self.errors.pop(0)


def test_launch_raises_with_the_launcher_name_and_counts_only_successes(monkeypatch):
    fn = _FakeLauncher([0, 700, 0])
    lib = type("Lib", (), {"match_topk2_launch": fn})()
    monkeypatch.setattr(build, "library", lambda: lib)
    devices = []
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: devices.append(dev) or contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("Stream", (), {"cuda_stream": 1234})())
    launches.clear()
    d1, valid = torch.zeros(2, 3), torch.ones(2, dtype=torch.bool)
    build.launch("match_topk2_launch", "match_topk2", d1, valid, None, 7, 0.5)
    assert fn.calls == [(d1.data_ptr(), valid.data_ptr(), None, 7, 0.5, 1234)]
    assert devices == [d1.device] and launches["match_topk2"] == 1
    with pytest.raises(RuntimeError, match="match_topk2_launch: CUDA error 700"):
        build.launch("match_topk2_launch", "match_topk2", d1, valid, None, 7, 0.5)
    assert launches["match_topk2"] == 1
    build.launch("match_topk2_launch", "match_topk2", d1, valid, None, 7, 0.5)
    assert launches["match_topk2"] == 2 and len(fn.calls) == 3
