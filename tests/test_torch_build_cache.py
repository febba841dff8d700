"""The kernel library's build cache: the key hashes the CUDA sources and
headers, the nvcc flags and the compiler's version, and a library built
for a key is loaded, not built again (no nvcc here: the build is
replaced by a stand-in that writes the file)."""

import shutil

import pytest

from vit_colmap_tpu_torch.kernels import build


@pytest.fixture
def csrc(tmp_path):
    d = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, d)
    return d


def test_key_covers_sources_headers_flags_and_compiler(csrc):
    key = build.cache_key(csrc, build.NVCC_FLAGS, "nvcc 12.4")
    assert key == build.cache_key(csrc, list(build.NVCC_FLAGS), "nvcc 12.4")
    assert len(key) == 16
    assert build.cache_key(csrc, build.NVCC_FLAGS, "nvcc 12.8") != key
    assert build.cache_key(csrc, build.NVCC_FLAGS + ["-lineinfo"], "nvcc 12.4") != key
    header = next(csrc.glob("*.cuh"))
    header.write_text(header.read_text() + "\n")
    edited = build.cache_key(csrc, build.NVCC_FLAGS, "nvcc 12.4")
    assert edited != key
    (csrc / "notes.txt").write_text("not a source")
    assert build.cache_key(csrc, build.NVCC_FLAGS, "nvcc 12.4") == edited
    source = next(csrc.glob("*.cu"))
    source.rename(csrc / "renamed.cu")
    assert build.cache_key(csrc, build.NVCC_FLAGS, "nvcc 12.4") != edited


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
    monkeypatch.setattr(build, "nvcc_version", lambda nvcc: "nvcc 12.4")
    monkeypatch.setattr(build, "build", fake_build)
    first = build.library_path()
    assert build.library_path() == first and len(builds) == 1
    assert first.parent.parent == tmp_path / "_build"
    assert build.log_path("match_topk2.cu") == first.parent / "match_topk2.nvcc.log"
    next(csrc.glob("*.cu")).write_text("// edited\n")
    second = build.library_path()
    assert second != first and len(builds) == 2 and first.exists()
