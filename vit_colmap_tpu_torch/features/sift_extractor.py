"""SIFT extractor on the GPU: the port's ``sift`` / ``colmap_sift``.

Counterpart of ``vit_colmap_tpu/features/sift_extractor.py``: images read
as gray (``utils.image_io.imread_gray``, cv2's ``IMREAD_GRAYSCALE``),
grouped by size with one camera per size, SIFT (``ops/sift.py``) on batches
of ``image_batch`` uint8 images, and 4-column keypoints (x, y, scale,
orientation) with x512-quantized uint8 descriptors written to the COLMAP
database.  The reference pads the last batch to a full one to keep its
compiled shape; the port has no compile to save and sends the batch as it
is (each image's result does not depend on its batchmates).
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional

import numpy as np

from vit_colmap_tpu_torch.database import ColmapDatabase
from vit_colmap_tpu_torch.device import resolve_device
from vit_colmap_tpu_torch.features.base_extractor import BaseExtractor, list_images
from vit_colmap_tpu_torch.ops.sift import extract_sift
from vit_colmap_tpu_torch.utils.config import CameraConfig
from vit_colmap_tpu_torch.utils.image_io import imread_gray

logger = logging.getLogger(__name__)


class SiftExtractor(BaseExtractor):
    def __init__(
        self,
        max_keypoints: int = 4096,
        num_octaves: int = 4,
        contrast_thresh: float = 0.02,
        image_batch: int = 4,
        num_orientations: int = 2,
        device=None,
    ):
        self.max_keypoints = max_keypoints
        self.num_octaves = num_octaves
        self.contrast_thresh = contrast_thresh
        self.image_batch = image_batch
        # COLMAP's max_num_orientations default (2): a keypoint copy at each
        # secondary orientation-histogram peak.
        self.num_orientations = num_orientations
        self.device = resolve_device(device)

    def extract(
        self,
        image_dir: Path,
        db_path: Path,
        camera_model: str,
        camera_params: Optional[list[float]] = None,
    ) -> None:
        files = list_images(Path(image_dir))
        if not files:
            logger.error("No images found in %s", image_dir)
            return

        groups: dict[tuple[int, int], list[tuple[Path, np.ndarray]]] = {}
        for f in files:
            try:
                img = imread_gray(f)
            except ValueError:
                logger.warning("Unreadable image skipped: %s", f)
                continue
            groups.setdefault(img.shape, []).append((f, img))

        db = ColmapDatabase(db_path)
        try:
            for (h, w), items in groups.items():
                params = camera_params or CameraConfig(
                    model=camera_model).get_default_params(w, h)
                cam_id = db.add_camera(camera_model, w, h, params,
                                       prior_focal_length=camera_params is not None)
                for s in range(0, len(items), self.image_batch):
                    chunk = items[s : s + self.image_batch]
                    # uint8 to the device; [0, 1] normalization happens there.
                    kpts_list, desc_list = extract_sift(
                        np.stack([im for _, im in chunk]),
                        max_keypoints=self.max_keypoints,
                        num_octaves=self.num_octaves,
                        contrast_thresh=self.contrast_thresh,
                        num_orientations=self.num_orientations,
                        device=self.device,
                    )
                    for (f, _), kp, dc in zip(chunk, kpts_list, desc_list):
                        image_id = db.add_image(f.name, camera_id=cam_id)
                        db.add_keypoints(image_id, kp)
                        db.add_descriptors(image_id, dc)
            db.commit()
        finally:
            db.close()


# Alias for the reference's CLI (--use-colmap-sift / --extractor colmap_sift).
ColmapSiftExtractor = SiftExtractor
