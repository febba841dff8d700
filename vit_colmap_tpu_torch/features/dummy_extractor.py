"""Deterministic fake extractor: the model-free end-to-end seam.

The port's counterpart of ``vit_colmap_tpu/features/dummy_extractor.py``,
with the same contract: a regular grid of keypoints (step 32, centred at
step/2 offsets) with 128-D uint8 descriptors seeded by grid position
(``seed + gx * 1000 + gy``), so that equal positions match across images
without any model, and 10 random 640x480 images written when the
directory is empty.  Images are read with ``utils.image_io`` (PNG and
PPM/PGM).

The descriptor bytes come from an integer hash of (position seed, byte
index) computed on the device, not from JAX's random generator, so they
differ from the reference's bytes; what the contract fixes, equal
descriptors at equal positions and distinct ones elsewhere, holds.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from vit_colmap_tpu_torch.database import ColmapDatabase
from vit_colmap_tpu_torch.device import resolve_device
from vit_colmap_tpu_torch.features.base_extractor import BaseExtractor, list_images
from vit_colmap_tpu_torch.utils.config import CameraConfig
from vit_colmap_tpu_torch.utils.image_io import imread_rgb, write_png

logger = logging.getLogger(__name__)

_MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32), in 16-bit halves of c so
    that no product leaves int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """An avalanching 32-bit integer hash of int64 x in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def dummy_features(seed: int, height: int, width: int, step: int = 32, dim: int = 128,
                   device=None):
    """Grid keypoints (K, 2) f32 and position-seeded descriptors (K, dim)
    uint8 of one image, computed on ``device``."""
    dev = resolve_device(device)
    ys = torch.arange(step // 2, height, step, dtype=torch.float32, device=dev)
    xs = torch.arange(step // 2, width, step, dtype=torch.float32, device=dev)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    kpts = torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=1)
    gx = (kpts[:, 0] / step).long()
    gy = (kpts[:, 1] / step).long()
    local_seeds = seed + gx * 1000 + gy
    byte = torch.arange(dim, device=dev)
    h = _hash32((local_seeds[:, None] * dim + byte[None]) & _MASK32)
    return kpts, (h & 0xFF).to(torch.uint8)


class DummyExtractor(BaseExtractor):
    def __init__(self, step: int = 32, seed: int = 42, device=None):
        self.step = step
        self.seed = seed
        self.device = resolve_device(device)

    def extract(
        self,
        image_dir: Path,
        db_path: Path,
        camera_model: str,
        camera_params: Optional[list[float]] = None,
    ) -> None:
        image_dir = Path(image_dir)
        image_files = list_images(image_dir)
        if not image_files:
            logger.info("No images found in %s, generating 10 dummy images", image_dir)
            image_dir.mkdir(parents=True, exist_ok=True)
            rng = np.random.default_rng(self.seed)
            for i in range(10):
                path = image_dir / f"dummy_{i:03d}.png"
                write_png(path, rng.integers(0, 256, (480, 640, 3), dtype=np.uint8))
                image_files.append(path)

        height, width = imread_rgb(image_files[0]).shape[:2]
        explicit_params = camera_params is not None
        if camera_params is None:
            camera_params = CameraConfig(model=camera_model).get_default_params(
                width, height)
        db = ColmapDatabase(db_path)
        try:
            camera_id = db.add_camera(camera_model, width, height, camera_params,
                                      prior_focal_length=explicit_params)
            for img_file in image_files:
                h, w = imread_rgb(img_file).shape[:2]
                kpts, desc = dummy_features(self.seed, h, w, step=self.step,
                                            device=self.device)
                image_id = db.add_image(img_file.name, camera_id=camera_id)
                db.add_keypoints(image_id, kpts.cpu().numpy())
                db.add_descriptors(image_id, desc.cpu().numpy())
            db.commit()
        finally:
            db.close()
