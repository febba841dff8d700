"""Trainable-ViT feature extractor on the GPU.

Counterpart of ``vit_colmap_tpu/features/trainable_vit_extractor.py``:
trained keypoint/descriptor heads (``models/feature_model.py``) on the
frozen DINOv2 backbone; a sigmoid score map, max-pool NMS, top-k (lower
index first among ties) with the threshold and a ``min_keypoints`` floor,
sub-cell offsets from the offset head ("head"), a quadratic fit on the
score map ("quad") or none, quarter-resolution cells scaled x4 back to
pixels, descriptors taken at the keypoint cells and quantized
``(d + 1) * 127.5`` to uint8, and **6-column COLMAP keypoints** (x, y,
scale 1, orientation, score, 0).

Weights: a reference-trained ``.pt``/``.pth`` (``models/convert.
load_torch_feature_model``: BatchNorms folded, norm-free heads, and the
embedded backbone when there is one), a checkpoint directory of the port's
trainer (``training/checkpoint.py``: GroupNorm heads, and the fine-tuned
backbone of a ``--train-backbone`` run), or none (random init).
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from vit_colmap_tpu_torch.database import ColmapDatabase
from vit_colmap_tpu_torch.device import resolve_device
from vit_colmap_tpu_torch.features.base_extractor import (
    BaseExtractor,
    list_images,
    read_rgb_groups,
)
from vit_colmap_tpu_torch.models.dinov2 import preprocess
from vit_colmap_tpu_torch.models.feature_model import make_feature_model
from vit_colmap_tpu_torch.ops.detect import nms_maxpool, quadratic_refine, top_k

logger = logging.getLogger(__name__)


class TrainableViTExtractor(BaseExtractor):
    def __init__(
        self,
        weights_path: Optional[str] = None,
        backbone: str = "vitb14",
        num_keypoints: int = 20480,
        nms_radius: int = 1,
        detection_threshold: float = 0.4,
        min_keypoints: int = 256,
        image_batch: int = 2,
        dtype: torch.dtype = torch.bfloat16,
        seed: int = 0,
        subpixel: Union[bool, str] = True,
        device=None,
    ):
        if subpixel is True:
            subpixel = "head"
        elif subpixel is False:
            subpixel = "none"
        if subpixel not in ("head", "quad", "none"):
            raise ValueError(f"unknown subpixel mode {subpixel!r}")
        self.subpixel = subpixel
        self.num_keypoints = num_keypoints
        self.nms_radius = nms_radius
        self.detection_threshold = detection_threshold
        # When fewer than min_keypoints NMS peaks clear the threshold, the
        # best peaks are kept anyway (the reference's floor); 0 restores
        # the bare threshold.
        self.min_keypoints = min(min_keypoints, num_keypoints)
        self.image_batch = image_batch
        self.device = resolve_device(device)

        is_dir = bool(weights_path) and Path(weights_path).is_dir()
        is_torch_ckpt = bool(weights_path) and str(weights_path).endswith((".pt", ".pth"))
        if weights_path and not (is_dir or is_torch_ckpt):
            raise ValueError(f"{weights_path}: expected a .pt or .pth checkpoint or a "
                             "checkpoint directory of the trainer")
        # Reference checkpoints carry eval-mode BatchNorms, folded into the
        # convs: their heads are norm-free.
        self.model, self.cfg, self.bcfg = make_feature_model(
            backbone, dtype=dtype, norm="none" if is_torch_ckpt else "group",
            generator=torch.Generator().manual_seed(seed))
        if is_torch_ckpt:
            self._load_torch_checkpoint(str(weights_path))
        elif is_dir:
            self._load_checkpoint(str(weights_path))
        else:
            logger.warning("No checkpoint provided; trainable heads are randomly initialized")
        self.model.to(self.device).eval().requires_grad_(False)

    def _load_torch_checkpoint(self, path: str) -> None:
        from vit_colmap_tpu_torch.models.convert import load_torch_feature_model

        heads, backbone = load_torch_feature_model(path)
        self.model.heads.load_state_dict(heads)
        if backbone is not None:
            missing, unexpected = self.model.backbone.load_state_dict(backbone, strict=False)
            if missing:
                raise ValueError(f"{path}: the embedded backbone lacks keys {missing}")
            if unexpected:  # e.g. the public checkpoints' mask_token
                logger.warning("Ignoring backbone keys %s", unexpected)
            logger.info("Restored the embedded DINOv2 backbone from %s", path)
        logger.info("Loaded the trained heads from %s", path)

    def _load_checkpoint(self, path: str) -> None:
        """A checkpoint directory of the port's trainer: its heads, and its
        backbone when the run fine-tuned one."""
        from vit_colmap_tpu_torch.training.checkpoint import load_checkpoint

        ckpt = load_checkpoint(path)
        self.model.heads.load_state_dict(ckpt["heads"])
        if "backbone" in ckpt:
            self.model.backbone.load_state_dict(ckpt["backbone"])
            logger.info("Restored the fine-tuned backbone from %s", path)
        logger.info("Loaded the trainable-head checkpoint from %s", path)

    # -------------------------------------------------------------- device
    @torch.no_grad()
    def select(self, out: dict[str, torch.Tensor]):
        """Head outputs -> (x, y) pixel coords, orientation, score, valid
        (B, k) and uint8 descriptors (B, k, D), k = min(num_keypoints, H4*W4),
        ranked by score."""
        scores = torch.sigmoid(out["score_logits"])  # (B, H4, W4)
        s = nms_maxpool(scores, self.nms_radius)
        B, H4, W4 = s.shape
        k = min(self.num_keypoints, H4 * W4)
        top, idx = top_k(s.reshape(B, -1), k)
        ys = torch.div(idx, W4, rounding_mode="floor").float()
        xs = (idx % W4).float()
        # Scores are sorted, so the threshold keeps a prefix and the floor
        # only adds the next best peaks; NMS-suppressed cells are exactly 0.
        rank = torch.arange(k, device=s.device)[None, :]
        valid = (top > self.detection_threshold) | ((rank < self.min_keypoints) & (top > 0.0))

        def gather(m: torch.Tensor) -> torch.Tensor:
            flat = m.reshape(B, H4 * W4, -1)
            return torch.gather(flat, 1, idx[..., None].expand(-1, -1, flat.shape[-1]))

        offs = gather(out["offsets"])
        orient = gather(out["orientation"][..., None])[..., 0]
        desc = gather(out["descriptors"])
        if self.subpixel == "none":
            offs = torch.zeros_like(offs)
        elif self.subpixel == "quad":  # on the raw (pre-NMS) score map
            offs = quadratic_refine(scores, torch.stack([xs, ys], dim=-1))
        x_px = (xs + 0.5 + offs[..., 0]) * 4.0
        y_px = (ys + 0.5 + offs[..., 1]) * 4.0
        desc_u8 = torch.clamp((desc + 1.0) * 127.5, 0, 255).to(torch.uint8)
        return x_px, y_px, orient, top, valid, desc_u8

    @torch.no_grad()
    def extract_batch_async(self, images_u8):
        """(B, H, W, 3) uint8 RGB (H, W multiples of 14) -> :meth:`select`'s
        device tensors; the host is not synchronized."""
        images = torch.as_tensor(images_u8).to(self.device)
        return self.select(self.model(preprocess(images)))

    def extract_batch(self, images_u8: np.ndarray):
        """numpy (x, y, orientation, score, valid, uint8 descriptors)."""
        return tuple(t.cpu().numpy() for t in self.extract_batch_async(images_u8))

    # ---------------------------------------------------------------- host
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
        db = ColmapDatabase(db_path)
        try:
            self._extract_groups(db, read_rgb_groups(files), camera_model, camera_params)
            db.commit()
        finally:
            db.close()

    def _batch_rows(self, outs, names, grid_wh, image_wh):
        """A batch's :meth:`select` outputs -> each image's valid keypoints
        as 6-column rows (x, y, scale 1, orientation, score, 0) in image
        pixels, and their uint8 descriptors."""
        rx, ry = image_wh[0] / grid_wh[0], image_wh[1] / grid_wh[1]
        x, y, orient, score, valid, desc = (t.cpu().numpy() for t in outs)
        rows = []
        for b in range(len(names)):
            v = valid[b]
            kpts = np.zeros((int(v.sum()), 6), np.float32)
            kpts[:, 0] = x[b][v] * rx
            kpts[:, 1] = y[b][v] * ry
            kpts[:, 2] = 1.0
            kpts[:, 3] = orient[b][v]
            kpts[:, 4] = score[b][v]
            rows.append((kpts, desc[b][v]))
        return rows
