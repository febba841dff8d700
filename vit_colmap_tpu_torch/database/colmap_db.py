"""COLMAP-schema SQLite database layer (the port's own copy).

Same schema, blobs and ``pair_id`` rule as ``vit_colmap_tpu/database/
colmap_db.py``, so a database written by either package reads the same:

* ``pair_id = image_id1 * MAX_IMAGE_ID + image_id2`` with ``image_id1 <
  image_id2`` enforced by swapping (and column-swapping the match blob);
* keypoints are float32 row-major blobs with 2, 4 or 6 columns;
* descriptors are uint8 row-major blobs;
* matches / two_view_geometries store uint32 index pairs.

Uses ``sqlite3`` and numpy only.
"""

from __future__ import annotations

import sqlite3
from contextlib import contextmanager
from pathlib import Path
from typing import Iterator, Optional, Sequence

import numpy as np

MAX_IMAGE_ID = 2**31 - 1

# COLMAP camera model IDs (public COLMAP model enumeration).
CAMERA_MODEL_IDS = {
    "SIMPLE_PINHOLE": 0,
    "PINHOLE": 1,
    "SIMPLE_RADIAL": 2,
    "RADIAL": 3,
    "OPENCV": 4,
    "OPENCV_FISHEYE": 5,
    "FULL_OPENCV": 6,
    "FOV": 7,
    "SIMPLE_RADIAL_FISHEYE": 8,
    "RADIAL_FISHEYE": 9,
    "THIN_PRISM_FISHEYE": 10,
}
CAMERA_MODEL_NAMES = {v: k for k, v in CAMERA_MODEL_IDS.items()}

CAMERA_MODEL_NUM_PARAMS = {
    "SIMPLE_PINHOLE": 3,  # f, cx, cy
    "PINHOLE": 4,  # fx, fy, cx, cy
    "SIMPLE_RADIAL": 4,  # f, cx, cy, k
    "RADIAL": 5,  # f, cx, cy, k1, k2
    "OPENCV": 8,
}

# two_view_geometries.config enum (COLMAP TwoViewGeometry::ConfigurationType).
TWO_VIEW_CONFIG = {
    "UNDEFINED": 0,
    "DEGENERATE": 1,
    "CALIBRATED": 2,
    "UNCALIBRATED": 3,
    "PLANAR": 4,
    "PANORAMIC": 5,
    "PLANAR_OR_PANORAMIC": 6,
    "WATERMARK": 7,
    "MULTIPLE": 8,
    "CALIBRATED_RIG": 9,
}

_SCHEMA = """
CREATE TABLE IF NOT EXISTS cameras (
    camera_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    model     INTEGER NOT NULL,
    width     INTEGER NOT NULL,
    height    INTEGER NOT NULL,
    params    BLOB,
    prior_focal_length INTEGER NOT NULL
);
CREATE TABLE IF NOT EXISTS images (
    image_id  INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    name      TEXT NOT NULL UNIQUE,
    camera_id INTEGER NOT NULL,
    prior_qw REAL, prior_qx REAL, prior_qy REAL, prior_qz REAL,
    prior_tx REAL, prior_ty REAL, prior_tz REAL,
    CONSTRAINT image_id_check CHECK(image_id >= 0 and image_id < 2147483647),
    FOREIGN KEY(camera_id) REFERENCES cameras(camera_id)
);
CREATE UNIQUE INDEX IF NOT EXISTS index_name ON images(name);
CREATE TABLE IF NOT EXISTS keypoints (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE
);
CREATE TABLE IF NOT EXISTS descriptors (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE
);
CREATE TABLE IF NOT EXISTS matches (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB
);
CREATE TABLE IF NOT EXISTS two_view_geometries (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    config INTEGER NOT NULL,
    F BLOB, E BLOB, H BLOB, qvec BLOB, tvec BLOB
);
"""


def image_ids_to_pair_id(image_id1: int, image_id2: int) -> int:
    if image_id1 > image_id2:
        image_id1, image_id2 = image_id2, image_id1
    return image_id1 * MAX_IMAGE_ID + image_id2


def pair_id_to_image_ids(pair_id: int) -> tuple[int, int]:
    image_id2 = pair_id % MAX_IMAGE_ID
    image_id1 = (pair_id - image_id2) // MAX_IMAGE_ID
    return int(image_id1), int(image_id2)


def _blob(arr: np.ndarray, dtype) -> bytes:
    return np.ascontiguousarray(arr, dtype=dtype).tobytes()


def _from_blob(blob, dtype, shape) -> np.ndarray:
    if blob is None:
        return np.zeros(shape, dtype=dtype)
    return np.frombuffer(blob, dtype=dtype).reshape(shape).copy()


class ColmapDatabase:
    """COLMAP database: the write API (add_camera / add_image /
    add_keypoints / add_descriptors / add_matches / add_two_view_geometry)
    and the read surface the matcher, verifier, mapper and metrics need."""

    def __init__(self, db_path: str | Path) -> None:
        self.path = str(db_path)
        self.conn = sqlite3.connect(self.path)
        # Batched-write friendly pragmas: the DB is a single-writer artifact.
        self.conn.execute("PRAGMA journal_mode=MEMORY")
        self.conn.execute("PRAGMA synchronous=OFF")
        self.conn.executescript(_SCHEMA)
        self.conn.commit()

    # ------------------------------------------------------------------ write
    def add_camera(
        self,
        model: str | int,
        width: int,
        height: int,
        params: Sequence[float],
        prior_focal_length: bool = False,
        camera_id: Optional[int] = None,
    ) -> int:
        model_id = CAMERA_MODEL_IDS[model] if isinstance(model, str) else int(model)
        cur = self.conn.execute(
            "INSERT INTO cameras VALUES (?, ?, ?, ?, ?, ?)",
            (
                camera_id,
                model_id,
                int(width),
                int(height),
                _blob(np.asarray(params, dtype=np.float64), np.float64),
                int(prior_focal_length),
            ),
        )
        return int(cur.lastrowid)

    def add_pinhole_camera(
        self, width: int, height: int, fx: float, fy: float, cx: float, cy: float
    ) -> int:
        return self.add_camera("PINHOLE", width, height, [fx, fy, cx, cy])

    def add_image(
        self, name: str, camera_id: int, image_id: Optional[int] = None
    ) -> int:
        cur = self.conn.execute(
            "INSERT INTO images VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (image_id, name, int(camera_id)) + (None,) * 7,
        )
        return int(cur.lastrowid)

    def add_keypoints(self, image_id: int, kpts: np.ndarray) -> None:
        kpts = np.asarray(kpts, dtype=np.float32)
        assert kpts.ndim == 2 and kpts.shape[1] in (2, 4, 6), kpts.shape
        self.conn.execute(
            "INSERT OR REPLACE INTO keypoints VALUES (?, ?, ?, ?)",
            (int(image_id), kpts.shape[0], kpts.shape[1], _blob(kpts, np.float32)),
        )

    def add_descriptors(self, image_id: int, desc: np.ndarray) -> None:
        desc = np.asarray(desc, dtype=np.uint8)
        assert desc.ndim == 2, desc.shape
        self.conn.execute(
            "INSERT OR REPLACE INTO descriptors VALUES (?, ?, ?, ?)",
            (int(image_id), desc.shape[0], desc.shape[1], _blob(desc, np.uint8)),
        )

    def add_matches(self, image_id1: int, image_id2: int, pairs: np.ndarray) -> None:
        pairs = np.asarray(pairs, dtype=np.uint32).reshape(-1, 2)
        if image_id1 > image_id2:
            pairs = pairs[:, ::-1]
        pair_id = image_ids_to_pair_id(image_id1, image_id2)
        self.conn.execute(
            "INSERT OR REPLACE INTO matches VALUES (?, ?, ?, ?)",
            (pair_id, pairs.shape[0], 2, _blob(pairs, np.uint32)),
        )

    def add_two_view_geometry(
        self,
        image_id1: int,
        image_id2: int,
        inlier_matches: np.ndarray,
        config: int = TWO_VIEW_CONFIG["CALIBRATED"],
        F: Optional[np.ndarray] = None,
        E: Optional[np.ndarray] = None,
        H: Optional[np.ndarray] = None,
        qvec: Optional[np.ndarray] = None,
        tvec: Optional[np.ndarray] = None,
    ) -> None:
        inlier_matches = np.asarray(inlier_matches, dtype=np.uint32).reshape(-1, 2)
        if image_id1 > image_id2:
            inlier_matches = inlier_matches[:, ::-1]
        pair_id = image_ids_to_pair_id(image_id1, image_id2)

        def mat(m, default_shape):
            if m is None:
                m = np.eye(*default_shape) if default_shape[0] == default_shape[1] else np.zeros(default_shape)
            return _blob(np.asarray(m, dtype=np.float64), np.float64)

        self.conn.execute(
            "INSERT OR REPLACE INTO two_view_geometries VALUES (?,?,?,?,?,?,?,?,?,?)",
            (
                pair_id,
                inlier_matches.shape[0],
                2,
                _blob(inlier_matches, np.uint32),
                int(config),
                mat(F, (3, 3)),
                mat(E, (3, 3)),
                mat(H, (3, 3)),
                mat(qvec if qvec is not None else np.array([1.0, 0, 0, 0]), (4,)),
                mat(tvec if tvec is not None else np.zeros(3), (3,)),
            ),
        )

    def commit(self) -> None:
        self.conn.commit()

    def close(self) -> None:
        self.conn.commit()
        self.conn.close()

    # ------------------------------------------------------------------- read
    def read_cameras(self) -> dict[int, dict]:
        out = {}
        for cid, model, w, h, params, prior in self.conn.execute(
            "SELECT camera_id, model, width, height, params, prior_focal_length"
            " FROM cameras"
        ):
            out[int(cid)] = {
                "camera_id": int(cid),
                "model": CAMERA_MODEL_NAMES.get(int(model), str(model)),
                "model_id": int(model),
                "width": int(w),
                "height": int(h),
                "params": np.frombuffer(params, dtype=np.float64).copy(),
                "prior_focal_length": bool(prior),
            }
        return out

    def read_images(self) -> dict[int, dict]:
        out = {}
        for iid, name, cid in self.conn.execute(
            "SELECT image_id, name, camera_id FROM images"
        ):
            out[int(iid)] = {"image_id": int(iid), "name": name, "camera_id": int(cid)}
        return out

    def read_keypoints(self, image_id: int) -> Optional[np.ndarray]:
        row = self.conn.execute(
            "SELECT rows, cols, data FROM keypoints WHERE image_id=?", (int(image_id),)
        ).fetchone()
        if row is None:
            return None
        return _from_blob(row[2], np.float32, (row[0], row[1]))

    def read_descriptors(self, image_id: int) -> Optional[np.ndarray]:
        row = self.conn.execute(
            "SELECT rows, cols, data FROM descriptors WHERE image_id=?",
            (int(image_id),),
        ).fetchone()
        if row is None:
            return None
        return _from_blob(row[2], np.uint8, (row[0], row[1]))

    def read_matches(self, image_id1: int, image_id2: int) -> Optional[np.ndarray]:
        pair_id = image_ids_to_pair_id(image_id1, image_id2)
        row = self.conn.execute(
            "SELECT rows, cols, data FROM matches WHERE pair_id=?", (pair_id,)
        ).fetchone()
        if row is None:
            return None
        m = _from_blob(row[2], np.uint32, (row[0], row[1]))
        if image_id1 > image_id2:
            m = m[:, ::-1]
        return m

    def read_all_matches(self) -> dict[tuple[int, int], np.ndarray]:
        out = {}
        for pair_id, rows, cols, data in self.conn.execute(
            "SELECT pair_id, rows, cols, data FROM matches"
        ):
            ids = pair_id_to_image_ids(pair_id)
            out[ids] = _from_blob(data, np.uint32, (rows, cols))
        return out

    def read_two_view_geometry(self, image_id1: int, image_id2: int):
        pair_id = image_ids_to_pair_id(image_id1, image_id2)
        row = self.conn.execute(
            "SELECT rows, cols, data, config, F, E, H, qvec, tvec"
            " FROM two_view_geometries WHERE pair_id=?",
            (pair_id,),
        ).fetchone()
        if row is None:
            return None
        rows, cols, data, config, F, E, H, qvec, tvec = row
        inliers = _from_blob(data, np.uint32, (rows, cols))
        if image_id1 > image_id2:
            inliers = inliers[:, ::-1]
        return {
            "inlier_matches": inliers,
            "config": int(config),
            "F": _from_blob(F, np.float64, (3, 3)),
            "E": _from_blob(E, np.float64, (3, 3)),
            "H": _from_blob(H, np.float64, (3, 3)),
            "qvec": _from_blob(qvec, np.float64, (4,)),
            "tvec": _from_blob(tvec, np.float64, (3,)),
        }

    def read_all_two_view_geometries(self) -> dict[tuple[int, int], dict]:
        out = {}
        for pair_id, rows, cols, data, config in self.conn.execute(
            "SELECT pair_id, rows, cols, data, config FROM two_view_geometries"
        ):
            ids = pair_id_to_image_ids(pair_id)
            out[ids] = {
                "inlier_matches": _from_blob(data, np.uint32, (rows, cols)),
                "config": int(config),
            }
        return out

    # ----------------------------------------------------------------- counts
    @property
    def num_cameras(self) -> int:
        return self.conn.execute("SELECT COUNT(*) FROM cameras").fetchone()[0]

    @property
    def num_images(self) -> int:
        return self.conn.execute("SELECT COUNT(*) FROM images").fetchone()[0]

    @property
    def num_keypoints(self) -> int:
        r = self.conn.execute("SELECT SUM(rows) FROM keypoints").fetchone()[0]
        return int(r or 0)

    @property
    def num_matches(self) -> int:
        r = self.conn.execute("SELECT SUM(rows) FROM matches").fetchone()[0]
        return int(r or 0)

    @property
    def num_matched_pairs(self) -> int:
        return self.conn.execute(
            "SELECT COUNT(*) FROM matches WHERE rows > 0"
        ).fetchone()[0]

    @property
    def num_verified_pairs(self) -> int:
        return self.conn.execute(
            "SELECT COUNT(*) FROM two_view_geometries WHERE rows > 0"
        ).fetchone()[0]

    # ---------------------------------------------------------------- helpers
    @staticmethod
    @contextmanager
    def open_database(db_path: str | Path) -> Iterator["ColmapDatabase"]:
        db = ColmapDatabase(db_path)
        try:
            yield db
        finally:
            db.close()

    @staticmethod
    def get_db_count(db: "ColmapDatabase", attr_name: str) -> int:
        attr = getattr(db, attr_name)
        return attr() if callable(attr) else attr
