"""The port's batched C++ database writer (``csrc/host/db_writer.cc``
through ``database/native.py``) and its build (``kernels/host_build.py``).

The JAX package's writer is the untouched ``native/db_writer.cc``, built
into a temporary directory with ``native/build.sh``'s flags, and its binding
is pointed at it; everything skips where g++ or ``libsqlite3.so.0`` is
absent.

Bounds: every table the same bytes through the port's native writer, the
JAX package's ``ColmapDatabase`` and the JAX package's native writer;
``match_exhaustive`` with verification writes the same ``matches`` and
``two_view_geometries`` rows through either of the port's writers, and its
counter names the one it opened.
"""

import logging
import shutil
import sqlite3
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import vit_colmap_tpu.database.native as jax_native
from test_torch_verify import make_scene_db
from vit_colmap_tpu.database import ColmapDatabase as JaxDatabase
from vit_colmap_tpu_torch.database import ColmapDatabase, native
from vit_colmap_tpu_torch.kernels import host_build
from vit_colmap_tpu_torch.pipeline.match import match_exhaustive
from vit_colmap_tpu_torch.utils.config import MatchingConfig

JAX_WRITER = Path(__file__).resolve().parents[1] / "native" / "db_writer.cc"
TABLES = ("cameras", "images", "keypoints", "descriptors", "matches", "two_view_geometries")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def port_lib():
    if native.load_native() is None:
        pytest.skip("the port's database writer is unavailable (g++ or libsqlite3.so.0)")
    return native


@pytest.fixture(scope="module")
def jax_lib(tmp_path_factory, port_lib):
    """The JAX package's writer, built with native/build.sh's flags."""
    out = tmp_path_factory.mktemp("jax_native") / "libvc_db_writer.so"
    build = subprocess.run(
        [shutil.which("g++"), "-O2", "-shared", "-fPIC", "-std=c++17", "-o", str(out),
         str(JAX_WRITER), "-l:libsqlite3.so.0", "-L/lib/x86_64-linux-gnu"],
        capture_output=True, text=True)
    if build.returncode != 0:
        pytest.skip(f"the JAX writer does not build here: {build.stderr[-300:]}")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_LIB_PATH", out)
        mp.setattr(jax_native, "_lib", None)
        assert jax_native.load_native() is not None
        yield jax_native


def _rows(db_path, table):
    con = sqlite3.connect(db_path)
    try:
        return con.execute(f"SELECT * FROM {table} ORDER BY 1").fetchall()
    finally:
        con.close()


def _write_all(writer, seed=0):
    """One camera of each prior, images, keypoints of 2, 4 and 6 columns,
    descriptors, matches in both id orders and two-view geometries with and
    without their matrices."""
    rng = np.random.default_rng(seed)
    c1 = writer.add_camera(1, 640, 480, [600.0, 610.0, 320.0, 240.0])
    c2 = writer.add_camera(0, 320, 200, [400.0, 160.0, 100.0], True)
    ids = [writer.add_image(f"img_{i}.jpg", c1 if i % 2 else c2) for i in range(4)]
    for i, cols in zip(ids, (2, 4, 6, 2)):
        writer.add_keypoints(i, rng.random((30 + i, cols)).astype(np.float32))
        writer.add_descriptors(i, rng.integers(0, 256, (30 + i, 128), dtype=np.uint8))
    for a, b in ((ids[0], ids[1]), (ids[3], ids[1]), (ids[2], ids[0])):
        m = rng.integers(0, 30, (17, 2)).astype(np.uint32)
        writer.add_matches(a, b, m)
        writer.add_two_view_geometry(
            a, b, m[:9], config=3, F=rng.standard_normal((3, 3)),
            E=rng.standard_normal((3, 3)), H=rng.standard_normal((3, 3)),
            qvec=rng.standard_normal(4), tvec=rng.standard_normal(3))
    writer.add_matches(ids[3], ids[2], np.zeros((0, 2), np.uint32))
    writer.add_two_view_geometry(ids[2], ids[3], np.zeros((0, 2), np.uint32), config=2)
    writer.commit()
    writer.close()


def test_roundtrip(port_lib, tmp_path):
    w = port_lib.NativeDatabaseWriter(tmp_path / "n.db")
    cid = w.add_camera(1, 640, 480, [600.0, 600.0, 320.0, 240.0])
    i1, i2 = w.add_image("a.png", cid), w.add_image("b.png", cid)
    rng = np.random.default_rng(0)
    k = rng.random((50, 2)).astype(np.float32)
    d = rng.integers(0, 255, (50, 128), dtype=np.uint8)
    for i in (i1, i2):
        w.add_keypoints(i, k)
        w.add_descriptors(i, d)
    m = np.stack([np.arange(10, dtype=np.uint32)] * 2, 1)
    m[:, 1] += 3
    w.add_matches(i2, i1, m)  # reversed: the columns swap
    F = np.arange(9, dtype=np.float64).reshape(3, 3)
    w.add_two_view_geometry(i2, i1, m[:5], config=2, F=F)
    w.close()
    with ColmapDatabase.open_database(tmp_path / "n.db") as db:
        assert db.num_images == 2
        np.testing.assert_array_equal(db.read_keypoints(i1), k)
        np.testing.assert_array_equal(db.read_descriptors(i2), d)
        np.testing.assert_array_equal(db.read_matches(i2, i1), m)
        np.testing.assert_array_equal(db.read_matches(i1, i2), m[:, ::-1])
        g = db.read_two_view_geometry(i1, i2)
        np.testing.assert_array_equal(g["inlier_matches"], m[:5, ::-1])
        np.testing.assert_array_equal(g["F"], F)
        assert db.read_cameras()[cid]["model"] == "PINHOLE"


def test_tables_equal_jax_writers(port_lib, jax_lib, tmp_path):
    dbs = {"port_native": port_lib.NativeDatabaseWriter(tmp_path / "a.db"),
           "jax_python": JaxDatabase(tmp_path / "b.db"),
           "jax_native": jax_lib.NativeDatabaseWriter(tmp_path / "c.db"),
           "port_python": ColmapDatabase(tmp_path / "d.db")}
    for writer in dbs.values():
        _write_all(writer)
    for table in TABLES:
        rows = [_rows(tmp_path / f"{c}.db", table) for c in "abcd"]
        assert len(rows[0]) > 0
        assert rows[0] == rows[1] == rows[2] == rows[3], table


def test_errors_raise_with_sqlite_message(port_lib, tmp_path):
    w = port_lib.NativeDatabaseWriter(tmp_path / "e.db")
    cid = w.add_camera(1, 64, 48, [1.0, 1.0, 32.0, 24.0])
    w.add_image("same.png", cid)
    with pytest.raises(RuntimeError, match="UNIQUE"):
        w.add_image("same.png", cid)
    # The cached statement was reset after the failure and serves again.
    assert w.add_image("other.png", cid) == 2
    w.close()
    with ColmapDatabase.open_database(tmp_path / "e.db") as db:
        assert db.num_images == 2
    with pytest.raises(RuntimeError, match="vc_open"):
        port_lib.NativeDatabaseWriter(tmp_path / "no_such_dir" / "x.db")


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("scene")
    make_scene_db(tmp / "scene.db")
    return tmp / "scene.db"


def test_match_exhaustive_rows_equal_with_either_writer(port_lib, scene, tmp_path,
                                                        monkeypatch):
    shutil.copy(scene, tmp_path / "native.db")
    shutil.copy(scene, tmp_path / "python.db")
    native.writers.clear()
    a = match_exhaustive(tmp_path / "native.db", MatchingConfig(), device="cpu")
    assert native.writers == {"native": 1}
    monkeypatch.setattr(native, "load_native", lambda: None)
    b = match_exhaustive(tmp_path / "python.db", MatchingConfig(), device="cpu")
    assert native.writers == {"native": 1, "python": 1}
    assert (a.matched_pairs, a.total_matches, a.verified_pairs, a.total_inliers) == (
        b.matched_pairs, b.total_matches, b.verified_pairs, b.total_inliers)
    assert a.verified_pairs == 7
    for table in TABLES:
        assert _rows(tmp_path / "native.db", table) == _rows(tmp_path / "python.db", table)


# ------------------------------------------------------------------ the build
@pytest.fixture
def host_dir(tmp_path):
    d = tmp_path / "host"
    shutil.copytree(host_build.HOST_DIR, d)
    return d


def test_build_once_and_compile_errors_raise_with_the_log(port_lib, host_dir, tmp_path,
                                                          monkeypatch):
    monkeypatch.setattr(host_build, "HOST_DIR", host_dir)
    monkeypatch.setattr(host_build, "BUILD_DIR", tmp_path / "_build")
    first = host_build.library_path("db_writer")
    assert first.exists() and first.parent.parent == tmp_path / "_build"
    assert "g++" in host_build.log_path(first).read_text()
    stamp = first.stat().st_mtime_ns
    assert host_build.library_path("db_writer") == first
    assert host_build.build_all(["db_writer"]) == {"db_writer": 0.0}
    assert first.stat().st_mtime_ns == stamp
    (host_dir / "db_writer.cc").write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        host_build.library_path("db_writer")
    assert "not C++" in str(err.value) or "error" in str(err.value)
    target = host_build.target_path("db_writer")
    assert not target.exists() and "error" in host_build.log_path(target).read_text()


def test_unavailable_without_compiler_or_runtime(monkeypatch, tmp_path, caplog):
    monkeypatch.setattr(host_build.shutil, "which", lambda name: None)
    with pytest.raises(host_build.Unavailable, match="g\\+\\+"):
        host_build.load("db_writer")
    monkeypatch.undo()
    monkeypatch.setattr(host_build, "find_soname", lambda soname: None)
    with pytest.raises(host_build.Unavailable, match="libsqlite3"):
        host_build.target_path("db_writer")
    with pytest.raises(host_build.Unavailable, match="JPEG"):
        host_build.target_path("image_io")
    # The binding then returns None with one warning, and the matcher's
    # bulk writes fall back to ColmapDatabase.
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_failed", False)
    native.writers.clear()
    with caplog.at_level(logging.WARNING):
        assert native.load_native() is None
        assert native.load_native() is None
        writer = native.open_bulk_writer(tmp_path / "f.db")
    assert isinstance(writer, ColmapDatabase) and native.writers == {"python": 1}
    writer.close()
    assert sum(r.message.startswith("Native database writer unavailable")
               for r in caplog.records) == 1
