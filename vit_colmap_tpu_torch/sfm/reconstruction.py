"""Reconstruction data model + COLMAP sparse-model IO.

The port's copy of ``vit_colmap_tpu/sfm/reconstruction.py`` (numpy only):
cameras / images (poses) / 3D points with tracks, plus writers for COLMAP's
standard text and binary sparse formats (cameras, images, points3D) so
external COLMAP tooling can open the output.  The writers produce the same
bytes as the reference's for the same model.

Conventions match COLMAP: poses are world->camera, rotation as quaternion
(w, x, y, z); ``Image.xys`` holds the keypoint coordinates and
``point3D_ids`` maps each keypoint to its 3D point (-1 if none).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from vit_colmap_tpu_torch.database.colmap_db import CAMERA_MODEL_IDS, CAMERA_MODEL_NUM_PARAMS


@dataclass
class Camera:
    camera_id: int
    model: str
    width: int
    height: int
    params: np.ndarray  # model-specific

    def K(self) -> np.ndarray:
        p = self.params
        if self.model == "PINHOLE":
            fx, fy, cx, cy = p[:4]
        elif self.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL"):
            fx = fy = p[0]
            cx, cy = p[1], p[2]
        else:
            fx = fy = p[0]
            cx, cy = self.width / 2.0, self.height / 2.0
        return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)


@dataclass
class Image:
    image_id: int
    name: str
    camera_id: int
    qvec: np.ndarray = field(default_factory=lambda: np.array([1.0, 0, 0, 0]))
    tvec: np.ndarray = field(default_factory=lambda: np.zeros(3))
    xys: np.ndarray = field(default_factory=lambda: np.zeros((0, 2)))
    point3D_ids: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))

    def R(self) -> np.ndarray:
        w, x, y, z = self.qvec / np.linalg.norm(self.qvec)
        return np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
            ]
        )

    def projection_center(self) -> np.ndarray:
        return -self.R().T @ self.tvec


@dataclass
class Point3D:
    point3D_id: int
    xyz: np.ndarray
    rgb: np.ndarray = field(default_factory=lambda: np.zeros(3, np.uint8))
    error: float = 0.0
    track: list[tuple[int, int]] = field(default_factory=list)  # (image_id, kp idx)


@dataclass
class Reconstruction:
    cameras: dict[int, Camera] = field(default_factory=dict)
    images: dict[int, Image] = field(default_factory=dict)
    points3D: dict[int, Point3D] = field(default_factory=dict)

    # ------------------------------------------------------------------ IO
    def write_text(self, path: Path | str) -> None:
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        with open(path / "cameras.txt", "w") as f:
            f.write("# Camera list: CAMERA_ID MODEL WIDTH HEIGHT PARAMS[]\n")
            for cam in self.cameras.values():
                params = " ".join(f"{p:.12g}" for p in cam.params)
                f.write(
                    f"{cam.camera_id} {cam.model} {cam.width} {cam.height} {params}\n"
                )
        with open(path / "images.txt", "w") as f:
            f.write(
                "# Image list: IMAGE_ID QW QX QY QZ TX TY TZ CAMERA_ID NAME\n"
                "#   POINTS2D[] as (X, Y, POINT3D_ID)\n"
            )
            for im in self.images.values():
                q, t = im.qvec, im.tvec
                f.write(
                    f"{im.image_id} {q[0]:.12g} {q[1]:.12g} {q[2]:.12g} {q[3]:.12g} "
                    f"{t[0]:.12g} {t[1]:.12g} {t[2]:.12g} {im.camera_id} {im.name}\n"
                )
                obs = " ".join(
                    f"{xy[0]:.6g} {xy[1]:.6g} {pid}"
                    for xy, pid in zip(im.xys, im.point3D_ids)
                )
                f.write(obs + "\n")
        with open(path / "points3D.txt", "w") as f:
            f.write(
                "# 3D point list: POINT3D_ID X Y Z R G B ERROR "
                "TRACK[] as (IMAGE_ID, POINT2D_IDX)\n"
            )
            for pt in self.points3D.values():
                xyz = " ".join(f"{v:.12g}" for v in pt.xyz)
                rgb = " ".join(str(int(v)) for v in pt.rgb)
                track = " ".join(f"{i} {j}" for i, j in pt.track)
                f.write(f"{pt.point3D_id} {xyz} {rgb} {pt.error:.6g} {track}\n")

    def write_binary(self, path: Path | str) -> None:
        """COLMAP binary sparse format (cameras.bin / images.bin /
        points3D.bin) — public COLMAP serialization."""
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        with open(path / "cameras.bin", "wb") as f:
            f.write(struct.pack("<Q", len(self.cameras)))
            for cam in self.cameras.values():
                model_id = CAMERA_MODEL_IDS[cam.model]
                f.write(
                    struct.pack("<iiQQ", cam.camera_id, model_id, cam.width, cam.height)
                )
                n = CAMERA_MODEL_NUM_PARAMS.get(cam.model, len(cam.params))
                f.write(
                    struct.pack(f"<{n}d", *np.asarray(cam.params[:n], np.float64))
                )
        with open(path / "images.bin", "wb") as f:
            f.write(struct.pack("<Q", len(self.images)))
            for im in self.images.values():
                f.write(struct.pack("<i", im.image_id))
                f.write(struct.pack("<4d", *np.asarray(im.qvec, np.float64)))
                f.write(struct.pack("<3d", *np.asarray(im.tvec, np.float64)))
                f.write(struct.pack("<i", im.camera_id))
                f.write(im.name.encode() + b"\x00")
                f.write(struct.pack("<Q", len(im.xys)))
                for xy, pid in zip(im.xys, im.point3D_ids):
                    f.write(struct.pack("<ddq", float(xy[0]), float(xy[1]), int(pid)))
        with open(path / "points3D.bin", "wb") as f:
            f.write(struct.pack("<Q", len(self.points3D)))
            for pt in self.points3D.values():
                f.write(struct.pack("<Q", pt.point3D_id))
                f.write(struct.pack("<3d", *np.asarray(pt.xyz, np.float64)))
                f.write(struct.pack("<3B", *np.asarray(pt.rgb, np.uint8)))
                f.write(struct.pack("<d", float(pt.error)))
                f.write(struct.pack("<Q", len(pt.track)))
                for i, j in pt.track:
                    f.write(struct.pack("<ii", int(i), int(j)))

    def write(self, path: Path | str) -> None:
        self.write_binary(path)
        self.write_text(path)

    # ------------------------------------------------------------- helpers
    def mean_reprojection_error(self) -> float:
        errs = [p.error for p in self.points3D.values()]
        return float(np.mean(errs)) if errs else 0.0

    def mean_track_length(self) -> float:
        tls = [len(p.track) for p in self.points3D.values()]
        return float(np.mean(tls)) if tls else 0.0


def read_text(path: Path | str) -> Reconstruction:
    """Read a COLMAP text sparse model (for round-trips and tests)."""
    path = Path(path)
    rec = Reconstruction()
    with open(path / "cameras.txt") as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            parts = line.split()
            rec.cameras[int(parts[0])] = Camera(
                camera_id=int(parts[0]),
                model=parts[1],
                width=int(parts[2]),
                height=int(parts[3]),
                params=np.array([float(p) for p in parts[4:]]),
            )
    with open(path / "images.txt") as f:
        lines = [l for l in f if not l.startswith("#")]
    for i in range(0, len(lines), 2):
        parts = lines[i].split()
        im = Image(
            image_id=int(parts[0]),
            name=parts[9],
            camera_id=int(parts[8]),
            qvec=np.array([float(p) for p in parts[1:5]]),
            tvec=np.array([float(p) for p in parts[5:8]]),
        )
        obs = lines[i + 1].split()
        if obs:
            arr = np.array(obs, dtype=np.float64).reshape(-1, 3)
            im.xys = arr[:, :2]
            im.point3D_ids = arr[:, 2].astype(np.int64)
        rec.images[im.image_id] = im
    with open(path / "points3D.txt") as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            parts = line.split()
            track = [
                (int(parts[j]), int(parts[j + 1])) for j in range(8, len(parts), 2)
            ]
            rec.points3D[int(parts[0])] = Point3D(
                point3D_id=int(parts[0]),
                xyz=np.array([float(p) for p in parts[1:4]]),
                rgb=np.array([int(p) for p in parts[4:7]], np.uint8),
                error=float(parts[7]),
                track=track,
            )
    return rec
