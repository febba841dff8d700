"""Hybrid extractor: classical keypoint detection + ViT descriptors, on the GPU.

Counterpart of ``vit_colmap_tpu/features/hybrid_extractor.py``: a classical
detector (OpenCV's SIFT, FAST, GFTT or ORB, here ``ops/cv_detectors.py`` on
the extractor's device) localizes keypoints on each image's gray
(``cvtColor(BGR2GRAY)`` of the colour image, ``utils/image_io.rgb_to_gray``),
the strongest ``max_keypoints`` by response are kept (a stable sort, as the
reference's), DINOv2 patch features of the area-resized image are sampled
bilinearly at those locations, projected by the PCA (loaded from
``pca_path``, fitted deterministically or set with ``set_pca``),
RootSIFT-normalized (L1, signed square root, L2) and quantized to signed
uint8.  The backbone runs with ``attn_impl="fixedmax_fused"``: kernel 1 on
the card.

``weights_path`` is a torch DINOv2 ``.pth``, or a checkpoint directory of
the port's trainer run with ``--train-backbone`` (a heads-only directory
raises); without it the backbone is a random init from ``seed``.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from vit_colmap_tpu_torch.database import ColmapDatabase
from vit_colmap_tpu_torch.device import resolve_device
from vit_colmap_tpu_torch.features.base_extractor import (
    BaseExtractor,
    list_images,
    read_rgb_groups,
)
from vit_colmap_tpu_torch.features.vit_extractor import load_backbone_weights
from vit_colmap_tpu_torch.models.dinov2 import (
    PATCH_SIZE,
    make_backbone,
    patch_grid_size,
    preprocess,
)
from vit_colmap_tpu_torch.ops import cv_detectors
from vit_colmap_tpu_torch.ops.interpolate import (
    apply_pca,
    bilinear_sample,
    fit_pca,
    load_pca,
    quantize_descriptors_signed,
)
from vit_colmap_tpu_torch.utils.config import CameraConfig
from vit_colmap_tpu_torch.utils.image_io import resize_area, rgb_to_gray

logger = logging.getLogger(__name__)

DETECTORS = ("sift", "fast", "gftt", "orb")


def rootsift_normalize(desc: torch.Tensor) -> torch.Tensor:
    """L1-normalize -> signed sqrt -> L2-normalize (RootSIFT)."""
    l1 = torch.clamp_min(desc.abs().sum(-1, keepdim=True), 1e-8)
    d = desc / l1
    d = torch.sign(d) * torch.sqrt(d.abs())
    return d / torch.clamp_min(torch.linalg.norm(d, dim=-1, keepdim=True), 1e-8)


class HybridExtractor(BaseExtractor):
    def __init__(
        self,
        weights_path: Optional[str] = None,
        backbone: str = "vitb14",
        detector: str = "sift",  # sift | fast | gftt | orb
        max_keypoints: int = 4096,
        descriptor_dim: int = 128,
        image_batch: int = 2,
        dtype: torch.dtype = torch.bfloat16,
        seed: int = 0,
        pca_path: Optional[str] = None,
        pca_fit_images: int = 8,
        device=None,
    ):
        if detector not in DETECTORS:
            raise ValueError(f"Unknown detector {detector!r} (one of {DETECTORS})")
        self.device = resolve_device(device)
        self.detector_name = detector
        self.max_keypoints = max_keypoints
        self.descriptor_dim = descriptor_dim
        self.image_batch = image_batch
        self.pca_path = pca_path
        self.pca_fit_images = pca_fit_images

        # Frozen inference -> the fixed-max attention kernel (kernel 1).
        self.model, self.cfg = make_backbone(
            backbone, dtype=dtype, attn_impl="fixedmax_fused",
            generator=torch.Generator().manual_seed(seed),
        )
        load_backbone_weights(self.model, weights_path, "HybridExtractor")
        self.model.to(self.device).eval().requires_grad_(False)
        # Loading the same pca_path as a ViTExtractor puts hybrid and ViT
        # descriptors in one projected space.
        self._pca: Optional[tuple[torch.Tensor, torch.Tensor]] = None
        if pca_path is not None and Path(pca_path).exists():
            self._pca = load_pca(pca_path, self.device)
            logger.info("Loaded persisted PCA from %s", pca_path)

    def set_pca(self, components, mean) -> None:
        """Install a PCA projection (e.g. fitted by another extractor)."""
        self._pca = (torch.as_tensor(np.array(components, np.float32)).to(self.device),
                     torch.as_tensor(np.array(mean, np.float32)).to(self.device))

    # ------------------------------------------------------------- device
    @torch.no_grad()
    def detect(self, gray: np.ndarray) -> np.ndarray:
        """(H, W) uint8 gray -> (K, 2) float32 pixel keypoints: the
        detector's output, strongest response first (stable among equal
        responses), cut to ``max_keypoints``."""
        g = torch.from_numpy(np.ascontiguousarray(gray)).to(self.device)
        name = self.detector_name
        if name == "sift":
            pts, resp = cv_detectors.detect_sift(g, self.max_keypoints)
        elif name == "fast":
            pts, resp = cv_detectors.detect_fast(g)
        elif name == "gftt":
            pts, resp = cv_detectors.detect_gftt(g, self.max_keypoints)
        else:
            pts, resp = cv_detectors.detect_orb(g, self.max_keypoints)
        order = torch.sort(resp, descending=True, stable=True).indices[: self.max_keypoints]
        return pts[order].cpu().numpy().reshape(-1, 2)

    @torch.no_grad()
    def _dense_features(self, images_u8) -> torch.Tensor:
        """(B, H, W, 3) uint8 RGB (H, W multiples of 14) -> (B, gh, gw, C) f32."""
        x = preprocess(torch.as_tensor(np.asarray(images_u8)).to(self.device))
        out = self.model(x)
        gh, gw = out["grid"]
        return out["x_norm_patchtokens"].reshape(x.shape[0], gh, gw, -1).float()

    @torch.no_grad()
    def describe(self, fmap: torch.Tensor, kpts_grid) -> np.ndarray:
        """(B, gh, gw, C) + (B, K, 2) grid coords -> (B, K, D) uint8."""
        grid = torch.as_tensor(np.asarray(kpts_grid, np.float32)).to(fmap.device)
        desc = bilinear_sample(fmap, grid)
        if self._pca is None:
            self._pca = fit_pca(fmap.reshape(-1, fmap.shape[-1]), self.descriptor_dim)
        desc = rootsift_normalize(apply_pca(desc, *self._pca))
        return quantize_descriptors_signed(desc).cpu().numpy()

    def _ensure_pca(self, rgbs_sorted: list[np.ndarray]) -> None:
        if self._pca is not None:
            return
        from vit_colmap_tpu_torch.features.pca_store import (
            fit_pca_deterministic,
            resolve_pca,
        )

        def dense_fn(batch: np.ndarray) -> torch.Tensor:
            step = max(1, self.image_batch)
            return torch.cat([self._dense_features(batch[i : i + step])
                              for i in range(0, len(batch), step)])

        self._pca = resolve_pca(
            self.pca_path,
            lambda: fit_pca_deterministic(dense_fn, rgbs_sorted, self.descriptor_dim,
                                          fit_images=self.pca_fit_images),
            self.device,
        )

    # --------------------------------------------------------------- host
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
        groups = read_rgb_groups(files)
        rgbs = {f: rgb for items in groups.values() for f, rgb in items}
        if rgbs:
            self._ensure_pca([rgbs[f] for f in files if f in rgbs])

        db = ColmapDatabase(db_path)
        try:
            for (oh, ow), items in groups.items():
                self._extract_group(db, items, (oh, ow), camera_model, camera_params)
            db.commit()
        finally:
            db.close()

    def _extract_group(self, db, items, image_hw, camera_model, camera_params) -> None:
        """One size group under one camera, in zero-padded batches of
        ``image_batch``."""
        oh, ow = image_hw
        th, tw = patch_grid_size(oh, ow)
        params = camera_params or CameraConfig(model=camera_model).get_default_params(ow, oh)
        cam_id = db.add_camera(camera_model, ow, oh, params,
                               prior_focal_length=camera_params is not None)
        B = self.image_batch
        for s in range(0, len(items), B):
            chunk = items[s : s + B]
            batch = np.zeros((B, th, tw, 3), np.uint8)
            kpts_px = []
            for b, (_f, rgb) in enumerate(chunk):
                kpts_px.append(self.detect(rgb_to_gray(rgb)))
                batch[b] = resize_area(rgb, tw, th)
            fmap = self._dense_features(batch)
            k_max = max((len(p) for p in kpts_px), default=0)
            if k_max == 0:
                for f, _ in chunk:
                    db.add_image(f.name, camera_id=cam_id)
                continue
            grid = np.zeros((B, k_max, 2), np.float32)
            for b, pts in enumerate(kpts_px):
                if len(pts):
                    # original px -> resized px -> feature-grid coords (with
                    # the -0.5 patch-centre offset)
                    gx = pts[:, 0] * (tw / ow) / PATCH_SIZE - 0.5
                    gy = pts[:, 1] * (th / oh) / PATCH_SIZE - 0.5
                    grid[b, : len(pts)] = np.stack([gx, gy], 1)
            desc = self.describe(fmap, grid)
            for b, (f, _) in enumerate(chunk):
                pts = kpts_px[b]
                image_id = db.add_image(f.name, camera_id=cam_id)
                db.add_keypoints(image_id, pts)
                db.add_descriptors(image_id, desc[b, : len(pts)])
