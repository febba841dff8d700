from vit_colmap_tpu_torch.database.colmap_db import (
    CAMERA_MODEL_IDS,
    CAMERA_MODEL_NAMES,
    MAX_IMAGE_ID,
    TWO_VIEW_CONFIG,
    ColmapDatabase,
    image_ids_to_pair_id,
    pair_id_to_image_ids,
)

__all__ = [
    "ColmapDatabase",
    "image_ids_to_pair_id",
    "pair_id_to_image_ids",
    "MAX_IMAGE_ID",
    "CAMERA_MODEL_IDS",
    "CAMERA_MODEL_NAMES",
    "TWO_VIEW_CONFIG",
]
