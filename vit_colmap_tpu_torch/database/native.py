"""ctypes binding of the batched C++ database writer (``csrc/host/db_writer.cc``).

Counterpart of ``vit_colmap_tpu/database/native.py``: the write surface of
:class:`~vit_colmap_tpu_torch.database.ColmapDatabase` backed by C++ that
keeps one SQLite transaction open from ``vc_begin`` to ``commit``, so the
matching and verification drivers write their blobs without a Python
sqlite3 call per row.  The schema, blobs and ``pair_id`` rule are
``colmap_db.py``'s.

The library is built with ``g++`` at first use (``kernels/host_build.py``).
``load_native()`` returns ``None``, with one warning giving the reason,
where ``g++`` or ``libsqlite3.so.0`` is absent; :func:`open_bulk_writer`
then falls back to ``ColmapDatabase``.  ``writers`` counts which writer
each bulk write opened (``"native"`` or ``"python"``), so a run can show
its route: ``writers.clear()`` before it, ``writers["native"]`` after.
"""

from __future__ import annotations

import ctypes
import logging
from collections import Counter
from pathlib import Path
from typing import Optional

import numpy as np

from vit_colmap_tpu_torch.database.colmap_db import ColmapDatabase
from vit_colmap_tpu_torch.kernels import host_build

logger = logging.getLogger(__name__)

writers: Counter = Counter()
_lib = None
_lib_failed = False

# Array arguments are passed as addresses (``ndarray.ctypes.data``, typed
# c_void_p): a ctypes pointer object per array costs more than the insert.
_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_SIGNATURES = {
    "vc_open": (_P, [ctypes.c_char_p]),
    "vc_close": (None, [_P]),
    "vc_last_error": (ctypes.c_char_p, [_P]),
    "vc_begin": (_I, [_P]),
    "vc_commit": (_I, [_P]),
    "vc_add_camera": (_I64, [_P, _I, _I, _I, _P, _I, _I]),
    "vc_add_image": (_I64, [_P, ctypes.c_char_p, _I64]),
    "vc_write_keypoints": (_I, [_P, _I64, _I, _I, _P]),
    "vc_write_descriptors": (_I, [_P, _I64, _I, _I, _P]),
    "vc_write_matches": (_I, [_P, _I64, _I64, _I, _P]),
    "vc_write_two_view_geometry": (_I, [_P, _I64, _I64, _I, _P, _I] + [_P] * 5),
}
# add_two_view_geometry's defaults (identity F, E, H and pose).
_EYE3 = np.eye(3)
_QVEC0 = np.array([1.0, 0.0, 0.0, 0.0])
_TVEC0 = np.zeros(3)


def load_native() -> Optional[ctypes.CDLL]:
    """The writer library, built at first use; ``None`` (warning once)
    where the compiler or a runtime library is absent."""
    global _lib, _lib_failed
    if _lib is not None:
        return _lib
    if _lib_failed:
        return None
    try:
        lib = host_build.load("db_writer")
    except (host_build.Unavailable, OSError) as e:
        logger.warning("Native database writer unavailable: %s", e)
        _lib_failed = True
        return None
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    _lib = lib
    return lib


def _blob(x, default) -> np.ndarray:
    return np.ascontiguousarray(default if x is None else x, np.float64)


class NativeDatabaseWriter:
    """Same write API as ColmapDatabase, backed by the C++ writer; every
    write between two commits is one transaction."""

    def __init__(self, db_path: str | Path):
        lib = load_native()
        if lib is None:
            raise RuntimeError("native database writer unavailable (g++ or "
                               "libsqlite3.so.0 missing)")
        self.lib = lib
        self.handle = lib.vc_open(str(db_path).encode())
        if not self.handle:
            raise RuntimeError(f"vc_open failed for {db_path}")
        self.lib.vc_begin(self.handle)

    def _check(self, rc: int, op: str) -> None:
        if rc != 0:
            err = self.lib.vc_last_error(self.handle).decode()
            raise RuntimeError(f"{op} failed: {err}")

    def add_camera(self, model_id: int, width: int, height: int,
                   params, prior_focal_length: bool = False) -> int:
        p = np.ascontiguousarray(params, np.float64)
        cid = self.lib.vc_add_camera(
            self.handle, int(model_id), int(width), int(height),
            p.ctypes.data, len(p), int(prior_focal_length),
        )
        if cid < 0:
            self._check(-1, "add_camera")
        return int(cid)

    def add_image(self, name: str, camera_id: int) -> int:
        iid = self.lib.vc_add_image(self.handle, name.encode(), int(camera_id))
        if iid < 0:
            self._check(-1, "add_image")
        return int(iid)

    def add_keypoints(self, image_id: int, kpts: np.ndarray) -> None:
        k = np.ascontiguousarray(kpts, np.float32)
        self._check(self.lib.vc_write_keypoints(
            self.handle, int(image_id), k.shape[0], k.shape[1], k.ctypes.data),
            "write_keypoints")

    def add_descriptors(self, image_id: int, desc: np.ndarray) -> None:
        d = np.ascontiguousarray(desc, np.uint8)
        self._check(self.lib.vc_write_descriptors(
            self.handle, int(image_id), d.shape[0], d.shape[1], d.ctypes.data),
            "write_descriptors")

    def add_matches(self, id1: int, id2: int, pairs: np.ndarray) -> None:
        m = np.ascontiguousarray(pairs, np.uint32).reshape(-1, 2)
        self._check(self.lib.vc_write_matches(
            self.handle, int(id1), int(id2), m.shape[0], m.ctypes.data),
            "write_matches")

    def add_two_view_geometry(
        self, id1: int, id2: int, inliers: np.ndarray, config: int = 2,
        F=None, E=None, H=None, qvec=None, tvec=None,
    ) -> None:
        m = np.ascontiguousarray(inliers, np.uint32).reshape(-1, 2)
        blobs = (_blob(F, _EYE3), _blob(E, _EYE3), _blob(H, _EYE3), _blob(qvec, _QVEC0),
                 _blob(tvec, _TVEC0))
        self._check(self.lib.vc_write_two_view_geometry(
            self.handle, int(id1), int(id2), m.shape[0], m.ctypes.data,
            int(config), *(b.ctypes.data for b in blobs)),
            "write_two_view_geometry")

    def commit(self) -> None:
        self._check(self.lib.vc_commit(self.handle), "commit")
        self.lib.vc_begin(self.handle)

    def close(self) -> None:
        if self.handle:
            self.lib.vc_commit(self.handle)
            self.lib.vc_close(self.handle)
            self.handle = None


def open_bulk_writer(db_path):
    """The native writer on ``db_path``, or ``ColmapDatabase`` where it
    cannot open (no library, or ``vc_open`` failed), as the JAX package's
    matcher falls back; ``writers`` counts which one opened."""
    try:
        writer = NativeDatabaseWriter(db_path)
        writers["native"] += 1
    except RuntimeError as e:
        logger.warning("Bulk writes go through ColmapDatabase: %s", e)
        writer = ColmapDatabase(db_path)
        writers["python"] += 1
    return writer
