"""Frozen DINOv2 ViT feature extractor on the GPU.

Counterpart of ``vit_colmap_tpu/features/vit_extractor.py``: DINOv2 patch
tokens, Harris/DoG saliency, soft-NMS binned top-k keypoints with quadratic
sub-cell refinement, bilinear descriptor sampling, PCA 768 -> 128, L2
normalization and signed uint8 quantization, grid -> image coordinates with
the +0.5 patch-centre offset, default intrinsics f = max(w, h), and the
directory -> COLMAP database contract of ``extract()``.  Descriptors stay on
the device for matching (``device_cache``).

``transfer_format`` "yuv420" or "yuv420c4" sends each batch to the card as
that wire format (``ops/transfer.py``: packed on the host and unpacked to
RGB on the card before the backbone).  ``extract()`` then takes the native
route where the host C++ decoder loads (``utils/native_io.py``), with the
JAX package's rules: it is decided once, when the extractor's first forward
is built inside ``extract()``; images are grouped by their header sizes
without a decode; only the PCA-fit subset is decoded to RGB (none when the
PCA file loads); each batch is decoded and resized straight into I420 on 2
threads (then ``i420_to_c4`` for yuv420c4), and an image whose decode failed
is skipped.  The native route's full-range JFIF YCbCr is sticky: from then
on every host pack and every unpack of the extractor is full range, a warm
second ``extract()`` included, which takes the host route (decode, area
resize, pack).  Otherwise the packs are cv2's studio range, as the
reference's cv2 path.

``quantize="int8"`` runs the backbone's transformer matmuls through
``QuantDense`` (int8 weights and activations, int32 products).

``weights_path`` is a torch DINOv2 ``.pth``, or a checkpoint directory of
the port's trainer run with ``--train-backbone`` (its fine-tuned backbone;
a heads-only directory raises).

Devices (``parallel/mesh.py``): images are data-parallel over a mesh's
data slots as in the JAX package: every visible card when there are
several and the device names no index (``"cuda"``, the default), a
``mesh=`` of slots, or else one slot on the device.  A batch rounds up to
a multiple of the slots with zero images whose outputs are dropped; each
slot runs the backbone (kernel 1), detection and the PCA on its share with
its own replica, on its own thread (one slot inline); outputs are gathered
in image order on the first slot's device (``self.device``), where the PCA
is fitted and the database rows and ``device_cache`` come from.
``device="cuda:0"`` pins one card.

``set_pca`` installs a projection; ``device_extract_pipelined`` (the device
rate: back-to-back extractions of one staged batch, one synchronization)
and ``device_extract_looped`` (a device-side checksum over perturbed
inputs) time the device path without host readback.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from vit_colmap_tpu_torch.database import ColmapDatabase
from vit_colmap_tpu_torch.device import resolve_device
from vit_colmap_tpu_torch.features.base_extractor import (
    BaseExtractor,
    add_group_camera,
    list_images,
    read_rgb_groups,
)
from vit_colmap_tpu_torch.models.dinov2 import (
    PATCH_SIZE,
    make_backbone,
    patch_grid_size,
    preprocess,
)
from vit_colmap_tpu_torch.ops.detect import detect_keypoints, quadratic_refine
from vit_colmap_tpu_torch.ops.interpolate import (
    apply_pca,
    bilinear_sample,
    decode_descriptors,
    fit_pca,
    l2_normalize,
    load_pca,
    quantize_descriptors_signed,
)
from vit_colmap_tpu_torch.ops.scoring import compute_saliency
from vit_colmap_tpu_torch.ops.transfer import (
    i420_to_c4,
    pack_batch_yuv420,
    pack_batch_yuv420_c4,
    pack_yuv420_full,
    unpack_yuv420,
    unpack_yuv420_c4,
)
from vit_colmap_tpu_torch.parallel.mesh import (
    Mesh,
    gather,
    pad_to_multiple,
    replicate_module,
    resolve_mesh,
    run_slots,
    shard_batch,
)
from vit_colmap_tpu_torch.utils.image_io import imread_rgb
from vit_colmap_tpu_torch.utils.profiling import span

logger = logging.getLogger(__name__)


def compact_valid_rows(desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(B, N, D), (B, N) -> (B, N, D) with valid rows moved to the front in
    order, so device rows line up with the database's keypoint rows."""
    order = torch.argsort((~valid).to(torch.int32), dim=1, stable=True)
    return torch.gather(desc, 1, order[..., None].expand_as(desc))


def load_backbone_weights(model: torch.nn.Module, weights_path: Optional[str],
                          extractor: str) -> None:
    """Load a frozen extractor's DINOv2 weights into ``model``: a checkpoint
    directory of the trainer's --train-backbone run (its fine-tuned
    backbone; a heads-only directory raises) or a torch ``.pth``; with no
    path the random init stays."""
    if weights_path and Path(weights_path).is_dir():
        from vit_colmap_tpu_torch.training.checkpoint import load_checkpoint

        ckpt = load_checkpoint(weights_path)
        if "backbone" not in ckpt:
            raise ValueError(
                f"{weights_path} holds no backbone params (heads-only "
                f"checkpoint?); the frozen {extractor} needs a "
                "--train-backbone checkpoint or a torch .pth file"
            )
        model.load_state_dict(ckpt["backbone"])
        logger.info("Loaded fine-tuned backbone from %s", weights_path)
    elif weights_path:
        from vit_colmap_tpu_torch.models.convert import load_torch_checkpoint

        logger.info("Loading backbone weights from %s", weights_path)
        missing, unexpected = model.load_state_dict(
            load_torch_checkpoint(str(weights_path)), strict=False
        )
        if missing:
            raise ValueError(f"{weights_path} lacks backbone keys {missing}")
        if unexpected:  # e.g. the public checkpoints' mask_token
            logger.warning("Ignoring checkpoint keys %s", unexpected)
    else:
        logger.warning("No weights provided; DINOv2 backbone is randomly initialized")


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
        mesh: Optional[Mesh] = None,
    ):
        if transfer_format not in ("rgb", "yuv420", "yuv420c4"):
            raise ValueError(f"unknown transfer_format {transfer_format!r}")
        self.mesh = mesh if mesh is not None else resolve_mesh(resolve_device(device))
        self.device = self.mesh.data_devices[0]
        # Data slots the batch is split over (the JAX package's _ndev).
        self._ndev = self.mesh.shape["data"]
        logger.info("ViTExtractor: %d data slots on %s", self._ndev,
                    [str(d) for d in self.mesh.data_devices])
        self._replicas: Optional[list] = None
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
        load_backbone_weights(self.model, weights_path, "ViTExtractor")
        self.model.to(self.device).eval().requires_grad_(False)
        self._pca: Optional[tuple[torch.Tensor, torch.Tensor]] = None
        if pca_path is not None and Path(pca_path).exists():
            self._pca = load_pca(pca_path, self.device)
            logger.info("Loaded persisted PCA from %s", pca_path)
        self.device_cache: dict[str, tuple[torch.Tensor, int]] = {}
        # The JAX package's forward is built at its first use; the native
        # route is open only to an extractor that has not built it yet.
        self._forward_built = False
        # Full-range JFIF YCbCr on the wire, set (for good) by the native
        # route; otherwise cv2's studio range.
        self._yuv_full_range = False

    def set_pca(self, components, mean) -> None:
        """Install a shared PCA projection (e.g. fitted by another extractor)
        on the extractor's device."""
        self._pca = (torch.as_tensor(np.array(components, np.float32)).to(self.device),
                     torch.as_tensor(np.array(mean, np.float32)).to(self.device))

    # -------------------------------------------------------------- device
    def to_wire(self, images_u8: np.ndarray) -> np.ndarray:
        """(B, H, W, 3) uint8 RGB -> the batch in ``transfer_format``, packed
        on the host, at full range once the native route has set it."""
        if self.transfer_format == "yuv420":
            if self._yuv_full_range:
                return np.stack([pack_yuv420_full(im) for im in np.asarray(images_u8)])
            return pack_batch_yuv420(np.asarray(images_u8))
        if self.transfer_format == "yuv420c4":
            return pack_batch_yuv420_c4(np.asarray(images_u8), full_range=self._yuv_full_range)
        return images_u8

    @property
    def batch_size(self) -> int:
        """Images a batch of ``extract()``: ``image_batch`` rounded up to a
        multiple of the data slots, so every slot gets an image."""
        return pad_to_multiple(self.image_batch, self._ndev)

    def _over_slots(self, body, batch, pack=None):
        """``body(model, share, pca)`` on each data slot's share of ``batch``
        (first packed by ``pack`` where given, then padded with zeros to a
        multiple of the slots), the slot's backbone replica and PCA on its
        device; the outputs gathered in batch order on ``self.device``, the
        padding dropped.  One slot runs inline on the extractor's own
        model."""
        with span("vc.extract.wire"):
            batch = torch.as_tensor(batch if pack is None else pack(batch))
            b0 = batch.shape[0]
            pad = (-b0) % self._ndev
            if pad:
                batch = torch.cat([batch, batch.new_zeros((pad, *batch.shape[1:]))])
            devices = self.mesh.data_devices
            if self._replicas is None:
                self._replicas = replicate_module(self.model, devices)
            pcas = [None if self._pca is None else tuple(t.to(d) for t in self._pca)
                    for d in devices]
        with span("vc.extract.h2d"):
            shares = shard_batch(batch, self.mesh)
        outs = run_slots(lambda i, share: body(self._replicas[i], share, pcas[i]), devices,
                         shares)
        out = gather(outs, self.device)
        if not pad:
            return out
        return out[:b0] if isinstance(out, torch.Tensor) else tuple(t[:b0] for t in out)

    @torch.no_grad()
    def dense_features(self, wire) -> torch.Tensor:
        """A batch in ``transfer_format`` (for "rgb" (B, H, W, 3) uint8; H, W
        multiples of 14) -> (B, gh, gw, C) f32; YUV wires are unpacked to
        RGB on each slot's device first."""
        self._forward_built = True
        return self._over_slots(lambda model, share, _pca: self._dense(model, share), wire)

    @span("vc.extract.forward")
    @torch.no_grad()
    def _dense(self, model, wire: torch.Tensor) -> torch.Tensor:
        if self.transfer_format == "yuv420":
            wire = unpack_yuv420(wire, full_range=self._yuv_full_range)
        elif self.transfer_format == "yuv420c4":
            wire = unpack_yuv420_c4(wire, full_range=self._yuv_full_range)
        x = preprocess(wire)
        out = model(x)
        gh, gw = out["grid"]
        return out["x_norm_patchtokens"].reshape(x.shape[0], gh, gw, -1)

    @span("vc.extract.detect")
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
            # Match-ready f32, as matching decodes it from the database.
            return xy, sc, valid, desc_u8, decode_descriptors(desc_u8, valid)
        return xy, sc, valid, desc_u8

    def extract_batch_async(self, images_u8, packed: bool = False):
        """One batch -> device tensors (xy grid coords, scores, valid, uint8
        desc[, f32 desc]); the host is not synchronized.  ``packed=True``
        means ``images_u8`` is already in ``transfer_format`` (for example
        from ``to_wire``); otherwise it is RGB and is packed here."""
        with span("vc.extract.batch"):
            return self._extract_async(images_u8, packed)

    def _extract_async(self, images_u8, packed: bool):
        self._forward_built = True
        pack = None if packed else self.to_wire
        if self._pca is not None:
            # The fused body on every slot: backbone, detection and PCA.
            return self._over_slots(
                lambda model, share, pca: self._detect(self._dense(model, share), *pca),
                images_u8, pack)
        fmap = self._over_slots(lambda model, share, _pca: self._dense(model, share),
                                images_u8, pack)
        flat = fmap.float().reshape(-1, fmap.shape[-1])
        self._pca = fit_pca(flat, self.descriptor_dim)
        logger.info("Fitted PCA %d->%d on %d tokens", fmap.shape[-1],
                    self.descriptor_dim, flat.shape[0])
        return self._over_slots(lambda _m, share, pca: self._detect(share, *pca), fmap)

    def _require_pca(self) -> None:
        if self._pca is None:
            raise RuntimeError("fit PCA before benchmarking (extract once)")

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.no_grad()
    def device_extract_looped(self, staged, reps: int) -> torch.Tensor:
        """Run the extraction ``reps`` times on the device, iteration i on
        ``staged`` + i (uint8 wraparound, so no two iterations see the same
        input), and return the checksum sum(scores) + sum(descriptor bytes)
        over all iterations as one device scalar; nothing is read back.
        ``staged`` is a batch already in ``transfer_format`` (``to_wire``)."""
        self._forward_built = True
        self._require_pca()
        staged = torch.as_tensor(staged).to(self.device)
        acc = torch.zeros((), dtype=torch.float32, device=self.device)
        for i in range(reps):
            _, sc, _valid, desc = self.extract_batch_async(staged + i % 256, packed=True)[:4]
            acc = (acc + sc.sum(dtype=torch.float32)
                   + desc.sum(dtype=torch.int32).to(torch.float32))
        return acc

    @torch.no_grad()
    def device_extract_pipelined(self, staged, reps: int) -> float:
        """Wall seconds of ``reps`` back-to-back extractions of ``staged`` (a
        batch in ``transfer_format``) with no readback between them: one
        warm call outside the timing, then the calls, then one
        synchronization on the last output."""
        self._forward_built = True
        self._require_pca()
        staged = torch.as_tensor(staged).to(self.device)
        self.extract_batch_async(staged, packed=True)[1].cpu()
        self._sync()
        t0 = time.perf_counter()
        out = None
        for _ in range(reps):
            out = self.extract_batch_async(staged, packed=True)
        if out is not None:
            out[1].cpu()
        self._sync()
        return time.perf_counter() - t0

    def extract_batch(self, images_u8: np.ndarray):
        """(B, H, W, 3) uint8 RGB (H, W multiples of 14) -> numpy
        (xy grid coords, scores, valid, uint8 desc[, f32 desc])."""
        with span("vc.extract.batch"):
            outs = self._extract_async(images_u8, False)
            with span("vc.extract.readback"):
                return tuple(t.cpu().numpy() for t in outs)

    def _ensure_pca(self, rgbs_sorted: list[np.ndarray]) -> None:
        """Fit (or load) the PCA on a canonical image sample so descriptors
        do not depend on image order."""
        if self._pca is not None:
            return
        from vit_colmap_tpu_torch.features.pca_store import (
            fit_pca_deterministic,
            resolve_pca,
        )

        self._forward_built = True

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

        native_io = self._native_route()
        if native_io is not None:
            groups = self._probe_groups(files, native_io)
            rgbs = {}
        else:
            groups = read_rgb_groups(files)
            rgbs = {f: rgb for items in groups.values() for f, rgb in items}
        # PCA from the first images in sorted-name order, not arrival order;
        # the native route decodes only that subset to RGB, and nothing when
        # the PCA file loads.
        if self._pca is None:
            pca_loadable = bool(self.pca_path) and Path(self.pca_path).exists()
            if native_io is not None and not pca_loadable:
                for f in files[: self.pca_fit_images]:
                    try:
                        rgbs[f] = imread_rgb(f)
                    except ValueError:
                        pass
            if rgbs or pca_loadable:
                self._ensure_pca([rgbs[f] for f in files if f in rgbs])

        db = ColmapDatabase(db_path)
        try:
            if native_io is not None:
                self._extract_native(db, groups, native_io, camera_model, camera_params)
            else:
                self._extract_groups(db, groups, camera_model, camera_params)
            db.commit()
        finally:
            db.close()

    def _native_route(self):
        """``utils.native_io`` when this ``extract()`` takes the native route:
        a YUV wire format, a forward not built yet and a decoder that loads.
        Taking it sets full range for good."""
        if self.transfer_format not in ("yuv420", "yuv420c4") or self._forward_built:
            return None
        from vit_colmap_tpu_torch.utils import native_io

        if native_io.load_native() is None:
            return None
        self._yuv_full_range = True
        return native_io

    @staticmethod
    def _probe_groups(files, native_io) -> dict[tuple[int, int], list[Path]]:
        """``files`` grouped by (height, width) from their headers, in file
        order; unreadable headers are skipped with a warning."""
        groups: dict[tuple[int, int], list[Path]] = {}
        for f in files:
            wh = native_io.probe_size(f)
            if wh is None:
                logger.warning("Unreadable image skipped: %s", f)
                continue
            groups.setdefault((wh[1], wh[0]), []).append(f)
        return groups

    def _extract_native(self, db, groups, native_io, camera_model: str,
                        camera_params: Optional[list[float]]) -> None:
        """Each group under one camera, decoded and resized in C++ straight
        into I420 batches of ``batch_size`` slots (2 threads), all launched
        before their rows are written; a slot whose decode failed is
        skipped.  nvJPEG decodes on the extractor's card."""
        card = None
        if self.device.type == "cuda":
            card = self.device.index if self.device.index is not None else \
                torch.cuda.current_device()
        for (oh, ow), gfiles in groups.items():
            th, tw = patch_grid_size(oh, ow)
            cam_id = add_group_camera(db, camera_model, camera_params, ow, oh)
            pending = []
            for start in range(0, len(gfiles), self.batch_size):
                chunk = gfiles[start : start + self.batch_size]
                packed, ok = native_io.decode_batch_i420(
                    chunk, tw, th, pad_to=self.batch_size, n_threads=2, device=card)
                names = []
                for f, good in zip(chunk, ok):
                    if not good:
                        logger.warning("Native decode failed: %s", f)
                    names.append(f.name if good else None)
                if not ok.any():
                    continue
                if self.transfer_format == "yuv420c4":
                    packed = i420_to_c4(packed)
                pending.append((names, self.extract_batch_async(packed, packed=True)))
            self._write_batches(db, cam_id, pending, (tw, th), (ow, oh))

    def _batch_rows(self, outs, names, grid_wh, image_wh):
        """A batch's outputs -> each image's valid keypoints in image pixels
        and its uint8 descriptors (None for a name of None); the
        row-compacted device descriptors go into ``device_cache``."""
        xy, _sc, valid, desc = outs
        desc_dev = compact_valid_rows(desc, valid)
        xy_np = xy.cpu().numpy()
        valid_np = valid.cpu().numpy()
        desc_np = desc_dev.cpu().numpy()
        rows = []
        for b, name in enumerate(names):
            if name is None:  # a slot whose decode failed
                rows.append(None)
                continue
            v = valid_np[b]
            cnt = int(v.sum())
            rows.append((self._map_coords(xy_np[b][v], grid_wh, image_wh), desc_np[b][:cnt]))
            self.device_cache[name] = (desc_dev[b], cnt)
        return rows
