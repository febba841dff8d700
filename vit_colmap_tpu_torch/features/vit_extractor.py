"""Frozen DINOv2 ViT feature extractor on the GPU.

Counterpart of ``vit_colmap_tpu/features/vit_extractor.py``: DINOv2 patch
tokens, Harris/DoG saliency, soft-NMS binned top-k keypoints with quadratic
sub-cell refinement, bilinear descriptor sampling, PCA 768 -> 128, L2
normalization and signed uint8 quantization, grid -> image coordinates with
the +0.5 patch-centre offset, default intrinsics f = max(w, h), and the
directory -> COLMAP database contract of ``extract()``.  Descriptors stay on
the device for matching (``device_cache``).

``transfer_format`` "yuv420" or "yuv420c4" sends each batch to the card as
that wire format (``ops/transfer.py``: packed on the host, cv2's studio
range, and unpacked to RGB on the card before the backbone), as the
reference's cv2 path does.

``quantize="int8"`` runs the backbone's transformer matmuls through
``QuantDense`` (int8 weights and activations, int32 products).

Not ported yet (raise): orbax checkpoint directories as ``weights_path``,
and the reference's native JPEG decoder (full-range I420 straight from
libjpeg).
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
from vit_colmap_tpu_torch.models.dinov2 import (
    PATCH_SIZE,
    make_backbone,
    preprocess,
)
from vit_colmap_tpu_torch.ops.detect import detect_keypoints, quadratic_refine
from vit_colmap_tpu_torch.ops.interpolate import (
    apply_pca,
    bilinear_sample,
    fit_pca,
    l2_normalize,
    load_pca,
    quantize_descriptors_signed,
)
from vit_colmap_tpu_torch.ops.scoring import compute_saliency
from vit_colmap_tpu_torch.ops.transfer import (
    pack_batch_yuv420,
    pack_batch_yuv420_c4,
    unpack_yuv420,
    unpack_yuv420_c4,
)

logger = logging.getLogger(__name__)


def compact_valid_rows(desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(B, N, D), (B, N) -> (B, N, D) with valid rows moved to the front in
    order, so device rows line up with the database's keypoint rows."""
    order = torch.argsort((~valid).to(torch.int32), dim=1, stable=True)
    return torch.gather(desc, 1, order[..., None].expand_as(desc))


class ViTExtractor(BaseExtractor):
    def __init__(
        self,
        weights_path: Optional[str] = None,
        backbone: str = "vitb14",
        max_keypoints: int = 4096,
        descriptor_dim: int = 128,
        saliency: str = "combined",
        nms_radius: int = 1,
        nms_mode: str = "soft",
        refine: bool = True,
        bin_size: int = 2,
        k_per_bin: int = 4,
        image_batch: int = 4,
        dtype: torch.dtype = torch.bfloat16,
        seed: int = 0,
        pca_path: Optional[str] = None,
        pca_fit_images: int = 8,
        transfer_format: str = "rgb",
        quantize: str = "none",
        attn_impl: str = "fixedmax_fused",
        emit_float_desc: bool = False,
        device=None,
    ):
        if transfer_format not in ("rgb", "yuv420", "yuv420c4"):
            raise ValueError(f"unknown transfer_format {transfer_format!r}")
        self.device = resolve_device(device)
        self.backbone_name = backbone
        self.max_keypoints = max_keypoints
        self.descriptor_dim = descriptor_dim
        self.saliency = saliency
        self.nms_radius = nms_radius
        self.nms_mode = nms_mode
        self.refine = refine
        self.bin_size = bin_size
        self.k_per_bin = k_per_bin
        self.image_batch = image_batch
        self.pca_path = pca_path
        self.pca_fit_images = pca_fit_images
        self.transfer_format = transfer_format
        self.emit_float_desc = emit_float_desc

        generator = torch.Generator().manual_seed(seed)
        self.model, self.cfg = make_backbone(
            backbone, dtype=dtype, attn_impl=attn_impl, quantize=quantize,
            generator=generator,
        )
        if weights_path and Path(weights_path).is_dir():
            raise NotImplementedError(
                "orbax checkpoint directories are not ported yet; pass a torch "
                "DINOv2 state dict (.pth)"
            )
        if weights_path:
            from vit_colmap_tpu_torch.models.convert import load_torch_checkpoint

            logger.info("Loading backbone weights from %s", weights_path)
            missing, unexpected = self.model.load_state_dict(
                load_torch_checkpoint(str(weights_path)), strict=False
            )
            if missing:
                raise ValueError(f"{weights_path} lacks backbone keys {missing}")
            if unexpected:  # e.g. the public checkpoints' mask_token
                logger.warning("Ignoring checkpoint keys %s", unexpected)
        else:
            logger.warning(
                "No weights provided; DINOv2 backbone is randomly initialized"
            )
        self.model.to(self.device).eval().requires_grad_(False)
        self._pca: Optional[tuple[torch.Tensor, torch.Tensor]] = None
        if pca_path is not None and Path(pca_path).exists():
            self._pca = load_pca(pca_path, self.device)
            logger.info("Loaded persisted PCA from %s", pca_path)
        self.device_cache: dict[str, tuple[torch.Tensor, int]] = {}

    # -------------------------------------------------------------- device
    def to_wire(self, images_u8: np.ndarray) -> np.ndarray:
        """(B, H, W, 3) uint8 RGB -> the batch in ``transfer_format``, packed
        on the host."""
        if self.transfer_format == "yuv420":
            return pack_batch_yuv420(np.asarray(images_u8))
        if self.transfer_format == "yuv420c4":
            return pack_batch_yuv420_c4(np.asarray(images_u8))
        return images_u8

    @torch.no_grad()
    def dense_features(self, wire) -> torch.Tensor:
        """A batch in ``transfer_format`` (for "rgb" (B, H, W, 3) uint8; H, W
        multiples of 14) -> (B, gh, gw, C) f32; YUV wires are unpacked to
        RGB on the device first."""
        wire = torch.as_tensor(wire).to(self.device)
        if self.transfer_format == "yuv420":
            wire = unpack_yuv420(wire)
        elif self.transfer_format == "yuv420c4":
            wire = unpack_yuv420_c4(wire)
        x = preprocess(wire)
        out = self.model(x)
        gh, gw = out["grid"]
        return out["x_norm_patchtokens"].reshape(x.shape[0], gh, gw, -1)

    @torch.no_grad()
    def _detect(self, fmap: torch.Tensor, pca_comps, pca_mean):
        fmap = fmap.float()
        scores = compute_saliency(fmap, self.saliency)
        xy, sc, valid = detect_keypoints(
            scores,
            nms_radius=self.nms_radius,
            bin_size=self.bin_size,
            k_per_bin=self.k_per_bin,
            k_total=self.max_keypoints,
            nms_mode=self.nms_mode,
        )
        if self.refine:
            xy = xy + quadratic_refine(scores, xy)
        desc = bilinear_sample(fmap, xy)
        desc = l2_normalize(apply_pca(desc, pca_comps, pca_mean))
        desc_u8 = quantize_descriptors_signed(desc)
        if self.emit_float_desc:
            # Match-ready f32: the uint8 round trip (decode, mask, renormalize),
            # identical to what matching decodes from the database.
            dq = desc_u8.float() / 127.5 - 1.0
            dq = torch.where(valid[..., None], dq, 0.0)
            return xy, sc, valid, desc_u8, l2_normalize(dq)
        return xy, sc, valid, desc_u8

    def extract_batch_async(self, images_u8, packed: bool = False):
        """One batch -> device tensors (xy grid coords, scores, valid, uint8
        desc[, f32 desc]); the host is not synchronized.  ``packed=True``
        means ``images_u8`` is already in ``transfer_format`` (for example
        from ``to_wire``); otherwise it is RGB and is packed here."""
        fmap = self.dense_features(images_u8 if packed else self.to_wire(images_u8))
        if self._pca is None:
            flat = fmap.float().reshape(-1, fmap.shape[-1])
            self._pca = fit_pca(flat, self.descriptor_dim)
            logger.info("Fitted PCA %d->%d on %d tokens", fmap.shape[-1],
                        self.descriptor_dim, flat.shape[0])
        return self._detect(fmap, *self._pca)

    def extract_batch(self, images_u8: np.ndarray):
        """(B, H, W, 3) uint8 RGB (H, W multiples of 14) -> numpy
        (xy grid coords, scores, valid, uint8 desc[, f32 desc])."""
        return tuple(t.cpu().numpy() for t in self.extract_batch_async(images_u8))

    def _ensure_pca(self, rgbs_sorted: list[np.ndarray]) -> None:
        """Fit (or load) the PCA on a canonical image sample so descriptors
        do not depend on image order."""
        if self._pca is not None:
            return
        from vit_colmap_tpu_torch.features.pca_store import (
            fit_pca_deterministic,
            resolve_pca,
        )

        def dense_fn(batch: np.ndarray) -> torch.Tensor:
            step = max(1, self.image_batch)
            return torch.cat([self.dense_features(self.to_wire(batch[i : i + step]))
                              for i in range(0, len(batch), step)])

        self._pca = resolve_pca(
            self.pca_path,
            lambda: fit_pca_deterministic(
                dense_fn, rgbs_sorted, self.descriptor_dim,
                fit_images=self.pca_fit_images,
            ),
            self.device,
        )

    # ---------------------------------------------------------------- host
    @staticmethod
    def _map_coords(
        xy_grid: np.ndarray, resized_wh: tuple[int, int], orig_wh: tuple[int, int]
    ) -> np.ndarray:
        """Grid coords -> original image pixels with the +0.5 patch-centre
        offset."""
        rx = orig_wh[0] / resized_wh[0]
        ry = orig_wh[1] / resized_wh[1]
        x = (xy_grid[:, 0] + 0.5) * PATCH_SIZE * rx
        y = (xy_grid[:, 1] + 0.5) * PATCH_SIZE * ry
        return np.stack([x, y], axis=1).astype(np.float32)

    def extract(
        self,
        image_dir: Path,
        db_path: Path,
        camera_model: str,
        camera_params: Optional[list[float]] = None,
    ) -> None:
        # name -> (row-compacted device descriptors (K, D) uint8, count),
        # consumed by pipeline/match.py without a database round trip.
        self.device_cache = {}
        files = list_images(Path(image_dir))
        if not files:
            logger.error("No images found in %s", image_dir)
            return

        groups = read_rgb_groups(files)
        # PCA from the first images in sorted-name order, not arrival order.
        rgbs = {f: rgb for items in groups.values() for f, rgb in items}
        if rgbs:
            self._ensure_pca([rgbs[f] for f in files if f in rgbs])

        db = ColmapDatabase(db_path)
        try:
            self._extract_groups(db, groups, camera_model, camera_params)
            db.commit()
        finally:
            db.close()

    def _batch_rows(self, outs, names, grid_wh, image_wh):
        """A batch's outputs -> each image's valid keypoints in image pixels
        and its uint8 descriptors; the row-compacted device descriptors go
        into ``device_cache``."""
        xy, _sc, valid, desc = outs
        desc_dev = compact_valid_rows(desc, valid)
        xy_np = xy.cpu().numpy()
        valid_np = valid.cpu().numpy()
        desc_np = desc_dev.cpu().numpy()
        rows = []
        for b, name in enumerate(names):
            v = valid_np[b]
            cnt = int(v.sum())
            rows.append((self._map_coords(xy_np[b][v], grid_wh, image_wh), desc_np[b][:cnt]))
            self.device_cache[name] = (desc_dev[b], cnt)
        return rows
