"""Extractor ABC — the directory-in, database-out contract.

The port's own copy of ``vit_colmap_tpu/features/base_extractor.py``:
``extract(image_dir, db_path, camera_model, camera_params)`` reads every
image in a directory and writes cameras/images/keypoints/descriptors into a
COLMAP database.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from pathlib import Path
from typing import Optional

IMAGE_EXTENSIONS = {".jpg", ".jpeg", ".png", ".bmp", ".tiff", ".tif"}


def list_images(image_dir: Path) -> list[Path]:
    if not image_dir.exists():
        return []
    return sorted(
        f for f in image_dir.iterdir() if f.suffix.lower() in IMAGE_EXTENSIONS
    )


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
