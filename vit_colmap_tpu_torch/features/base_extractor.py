"""Extractor ABC — the directory-in, database-out contract.

The port's own copy of ``vit_colmap_tpu/features/base_extractor.py``:
``extract(image_dir, db_path, camera_model, camera_params)`` reads every
image in a directory and writes cameras/images/keypoints/descriptors into a
COLMAP database.
"""

from __future__ import annotations

import logging
from abc import ABC, abstractmethod
from pathlib import Path
from typing import Optional

import numpy as np

from vit_colmap_tpu_torch.models.dinov2 import patch_grid_size
from vit_colmap_tpu_torch.utils.config import CameraConfig
from vit_colmap_tpu_torch.utils.image_io import imread_rgb, resize_area

logger = logging.getLogger(__name__)

IMAGE_EXTENSIONS = {".jpg", ".jpeg", ".png", ".bmp", ".tiff", ".tif"}


def list_images(image_dir: Path) -> list[Path]:
    if not image_dir.exists():
        return []
    return sorted(
        f for f in image_dir.iterdir() if f.suffix.lower() in IMAGE_EXTENSIONS
    )


def read_rgb_groups(files: list[Path]) -> dict[tuple[int, int], list[tuple[Path, np.ndarray]]]:
    """The readable images of ``files`` as RGB, grouped by (height, width)
    in file order; unreadable files are skipped with a warning."""
    groups: dict[tuple[int, int], list[tuple[Path, np.ndarray]]] = {}
    for f in files:
        try:
            rgb = imread_rgb(f)
        except ValueError:
            logger.warning("Unreadable image skipped: %s", f)
            continue
        groups.setdefault(rgb.shape[:2], []).append((f, rgb))
    return groups


def add_group_camera(db, camera_model: str, camera_params: Optional[list[float]],
                     width: int, height: int) -> int:
    """The camera of one image size: ``camera_params`` as a prior, or the
    model's defaults for the size (f = max(w, h))."""
    params = camera_params or CameraConfig(model=camera_model).get_default_params(width, height)
    return db.add_camera(camera_model, width, height, params,
                         prior_focal_length=camera_params is not None)


class BaseExtractor(ABC):
    @abstractmethod
    def extract(
        self,
        image_dir: Path,
        db_path: Path,
        camera_model: str,
        camera_params: Optional[list[float]] = None,
    ) -> None:
        """Process images in ``image_dir`` and write features into the COLMAP
        database at ``db_path``."""
        raise NotImplementedError

    # The ViT extractors' host loop: subclasses that use it have
    # ``image_batch`` (or ``batch_size``, the ViT extractor's rounded to
    # its mesh), ``extract_batch_async`` and ``_batch_rows``.
    def _extract_groups(self, db, groups, camera_model: str,
                        camera_params: Optional[list[float]]) -> None:
        """Each group of :func:`read_rgb_groups` under one camera, its images
        area-resized to the patch grid in batches of ``image_batch``.  Every
        batch is launched first; the database writes of batch k then overlap
        the device work of later batches.  ``_batch_rows(outs, names,
        grid_wh, image_wh)`` turns a batch's outputs into each image's
        (keypoints, descriptors) rows."""
        for (oh, ow), items in groups.items():
            th, tw = patch_grid_size(oh, ow)
            cam_id = add_group_camera(db, camera_model, camera_params, ow, oh)
            pending = []
            step = getattr(self, "batch_size", self.image_batch)
            for start in range(0, len(items), step):
                chunk = items[start : start + step]
                batch = np.stack([resize_area(rgb, tw, th) for _, rgb in chunk])
                pending.append(([f.name for f, _ in chunk], self.extract_batch_async(batch)))
            self._write_batches(db, cam_id, pending, (tw, th), (ow, oh))

    def _write_batches(self, db, cam_id: int, pending, grid_wh, image_wh) -> None:
        """The rows of each launched batch ``(names, outputs)`` into the
        database, in order; a name of None is a slot to skip (the rows of
        the others stay aligned)."""
        for names, outs in pending:
            rows = self._batch_rows(outs, names, grid_wh, image_wh)
            for name, row in zip(names, rows):
                if name is None:
                    continue
                image_id = db.add_image(name, camera_id=cam_id)
                db.add_keypoints(image_id, row[0])
                db.add_descriptors(image_id, row[1])
