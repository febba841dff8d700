#!/usr/bin/env python
"""Bisect the trainable ViT's reconstruction geometry error, on the
PyTorch/CUDA port.

Counterpart of ``scripts/bisect_geometry.py``, with its flags, variants and
printed lines.  Two error sources are possible: keypoint localization
(quarter-resolution cells plus a trained offset head bounded at +-2 px,
against SIFT's sub-pixel refinement) and descriptor matching.  Each variant
runs the same match, verify and mapper stages (``pipeline/match.
match_exhaustive``, ``sfm/incremental.incremental_mapping``) on a database
built its own way, so the two are separated:

  asis          trainable keypoints + trainable descriptors (baseline)
  offsets0      trainable keypoints snapped to cell centres (offset head
                zeroed) + trainable descriptors
  quad          training-free quadratic peak refinement on the score map
                instead of the learned offset head
  siftloc       SIFT keypoint locations + trainable-head descriptors
                bilinearly sampled there (``ops/interpolate.bilinear_sample``),
                renormalized, quantized with the signed rule
  sift          pure SIFT control (same scene, same mapper)

It also reports the spatial dispersion of each variant's keypoints on the
first image.  On the card the trainable extractor's backbone runs the
fixed-max attention kernel (``attention_qkv``, ``attn_impl=
"fixedmax_fused"``) and matching runs the matching kernel
(``match_topk2_colmax``).  ``dispatch_rt_ms`` keeps the JAX key: here it is
``utils/profiling.relay_epoch_probe``, the least milliseconds of one
trivial launch and ``torch.cuda.synchronize()`` (null on the CPU).  Images
are read with ``utils/image_io.imread_rgb`` and resized with
``resize_area`` (OpenCV's ``INTER_AREA``).  Without ``--work-dir`` the
work goes to a new temporary directory.

    python3 scripts/torch_bisect_geometry.py --images 50 --weights CKPT \\
        [--variants asis,offsets0,siftloc,sift]                   # the card
    python3 scripts/torch_bisect_geometry.py --tiny --device cpu

``--tiny`` is 6 views at 126 x 168, vits14, 256 SIFT and 512 trainable
keypoints.  Without CUDA and without ``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def spatial_stats(kpts: np.ndarray, w: int, h: int, grid: int = 8) -> dict:
    """Keypoint spatial dispersion: occupancy + entropy over a grid."""
    if len(kpts) == 0:
        return {"n": 0, "cells_occupied": 0, "entropy_norm": 0.0}
    gx = np.clip((kpts[:, 0] / w * grid).astype(int), 0, grid - 1)
    gy = np.clip((kpts[:, 1] / h * grid).astype(int), 0, grid - 1)
    counts = np.bincount(gy * grid + gx, minlength=grid * grid)
    p = counts / counts.sum()
    nz = p[p > 0]
    ent = float(-(nz * np.log(nz)).sum() / np.log(grid * grid))
    return {
        "n": int(len(kpts)),
        "cells_occupied": int((counts > 0).sum()),
        "cells_total": grid * grid,
        "entropy_norm": round(ent, 4),
    }


def trainable_extractor(args, **kw):
    from vit_colmap_tpu_torch.features.trainable_vit_extractor import TrainableViTExtractor

    return TrainableViTExtractor(weights_path=args.weights, backbone=args.backbone,
                                 device=args.device, **kw)


def build_db_trainable(scene_dir, db_path, cam_params, args, subpixel):
    ex = trainable_extractor(args, num_keypoints=args.budget, nms_radius=1,
                             detection_threshold=0.4, subpixel=subpixel)
    ex.extract(scene_dir, db_path, "PINHOLE", cam_params)
    return ex


def build_db_sift(scene_dir, db_path, cam_params, args):
    from vit_colmap_tpu_torch.features.sift_extractor import SiftExtractor

    ex = SiftExtractor(max_keypoints=args.max_keypoints, device=args.device)
    ex.extract(scene_dir, db_path, "PINHOLE", cam_params)
    return ex


def resample_descriptors(ex, scene_dir, db_path) -> None:
    """Overwrite every image's descriptors with ``ex``'s trainable-head
    descriptors bilinearly sampled at the database's (SIFT) keypoints."""
    import torch

    from vit_colmap_tpu_torch.database import ColmapDatabase
    from vit_colmap_tpu_torch.models.dinov2 import patch_grid_size, preprocess
    from vit_colmap_tpu_torch.ops.interpolate import bilinear_sample
    from vit_colmap_tpu_torch.utils.image_io import imread_rgb, resize_area

    db = ColmapDatabase(db_path)
    try:
        for image_id, meta in db.read_images().items():
            kpts = db.read_keypoints(image_id)
            if kpts is None or len(kpts) == 0:
                continue
            rgb = imread_rgb(Path(scene_dir) / meta["name"])
            oh, ow = rgb.shape[:2]
            th, tw = patch_grid_size(oh, ow)
            if (oh, ow) != (th, tw):
                rgb = resize_area(rgb, tw, th)
            with torch.no_grad():
                images = torch.from_numpy(rgb[None]).to(ex.device)
                fmap = ex.model(preprocess(images))["descriptors"][:1].float()  # (1, H4, W4, D)
                # Original px -> resized px -> quarter-res grid coords (the
                # inverse of the extractor's (cell + 0.5) * 4 * rx mapping).
                rx, ry = ow / tw, oh / th
                gx = kpts[:, 0] / rx / 4.0 - 0.5
                gy = kpts[:, 1] / ry / 4.0 - 0.5
                xy = torch.from_numpy(np.stack([gx, gy], axis=1).astype(np.float32))
                d = bilinear_sample(fmap, xy[None].to(ex.device))[0]
                # Re-normalize after interpolation (the head emits unit-L2
                # cells; interpolated vectors land inside the sphere), then
                # quantize with the trainable extractor's signed rule.
                d = d / torch.clamp_min(torch.linalg.norm(d, dim=-1, keepdim=True), 1e-8)
                desc = torch.clamp((d + 1.0) * 127.5, 0, 255).to(torch.uint8).cpu().numpy()
            db.conn.execute("DELETE FROM descriptors WHERE image_id = ?", (image_id,))
            db.add_descriptors(image_id, desc)
        db.commit()
    finally:
        db.close()


def replace_desc_with_trainable(scene_dir, db_path, args):
    """The trainable model (for its weights only) and :func:`resample_descriptors`."""
    resample_descriptors(trainable_extractor(args), scene_dir, db_path)


def run_stages(scene_dir, db_path, out_dir, cam_params, signed_desc, device=None):
    """match+verify+incremental SfM on a prepared DB; returns metrics."""
    from vit_colmap_tpu_torch.pipeline.match import match_exhaustive
    from vit_colmap_tpu_torch.sfm.align import best_pose_errors, gt_poses_for_rendered_scene
    from vit_colmap_tpu_torch.sfm.incremental import incremental_mapping
    from vit_colmap_tpu_torch.utils.config import Config

    config = Config()
    if signed_desc:
        config.matching.descriptor_encoding = "signed"
    t0 = time.perf_counter()
    match_exhaustive(db_path, config.matching, device=device)
    t_match = time.perf_counter() - t0
    t0 = time.perf_counter()
    recs = incremental_mapping(db_path, scene_dir, Path(out_dir) / "sparse",
                               config.reconstruction, device=device)
    t_recon = time.perf_counter() - t0
    row = {"match_s": round(t_match, 1), "recon_s": round(t_recon, 1)}
    if recs:
        big = max(recs.values(), key=lambda r: len(r.images))
        row.update(
            registered=sum(len(r.images) for r in recs.values()),
            points3d=sum(len(r.points3D) for r in recs.values()),
            reproj_px=round(big.mean_reprojection_error(), 3),
        )
        pose = best_pose_errors(recs, gt_poses_for_rendered_scene(scene_dir))
        if pose:
            row.update(
                rot_err_deg=round(pose["pose_rot_err_deg_mean"], 4),
                rot_err_deg_max=round(pose["pose_rot_err_deg_max"], 4),
                center_err_rel=round(pose["pose_center_err_rel_mean"], 5),
                aligned_cameras=pose["aligned_cameras"],
            )
    else:
        row.update(registered=0, points3d=0)
    return row


def dispatch_rt_ms(device) -> float | None:
    from vit_colmap_tpu_torch.utils.profiling import relay_epoch_probe

    return round(relay_epoch_probe(), 2) if device.type == "cuda" else None


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--images", type=int, default=50)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--backbone", default="vitb14")
    ap.add_argument("--weights", default=None)
    ap.add_argument("--budget", type=int, default=4096,
                    help="trainable keypoint budget (pipeline SfM default)")
    ap.add_argument("--max-keypoints", type=int, default=2048,
                    help="SIFT budget (pipeline default)")
    ap.add_argument("--work-dir", type=Path, default=None)
    ap.add_argument("--variants", default="asis,offsets0,quad,siftloc,sift")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    if args.tiny:
        args.images, args.height, args.width = 6, 126, 168
        args.max_keypoints, args.budget = 256, 512
        args.backbone = "vits14"

    from vit_colmap_tpu_torch.database import ColmapDatabase
    from vit_colmap_tpu_torch.dataloader.synthetic_benchmark import render_multiview_scene
    from vit_colmap_tpu_torch.device import resolve_device

    device = resolve_device(args.device)  # raises without CUDA unless --device cpu
    work = args.work_dir or Path(tempfile.mkdtemp(prefix="torch_bisect_"))
    image_dir = work / "images"
    if not image_dir.exists():
        _, K = render_multiview_scene(
            image_dir, n_cams=args.images, size=(args.height, args.width),
            focal=float(max(args.height, args.width)) * 0.94, seed=7,
        )
        (work / "camera.json").write_text(json.dumps(
            {"params": [K[0, 0], K[1, 1], K[0, 2], K[1, 2]]}
        ))
    cam_params = [float(p) for p in json.loads((work / "camera.json").read_text())["params"]]

    rows = {}
    for variant in [v for v in args.variants.split(",") if v]:
        print(f"=== variant: {variant} ===", flush=True)
        vdir = work / variant
        vdir.mkdir(parents=True, exist_ok=True)
        db_path = vdir / "db.db"
        if db_path.exists():
            db_path.unlink()
        rt0 = dispatch_rt_ms(device)
        t0 = time.perf_counter()
        if variant in ("asis", "offsets0", "quad"):
            subpixel = {"asis": "head", "offsets0": "none", "quad": "quad"}[variant]
            build_db_trainable(image_dir, db_path, cam_params, args, subpixel)
            signed = True
        elif variant == "sift":
            build_db_sift(image_dir, db_path, cam_params, args)
            signed = False
        elif variant == "siftloc":
            build_db_sift(image_dir, db_path, cam_params, args)
            replace_desc_with_trainable(image_dir, db_path, args)
            signed = True
        else:
            raise SystemExit(f"unknown variant {variant}")
        t_extract = time.perf_counter() - t0

        # Spatial dispersion of the first image's keypoints.
        with ColmapDatabase.open_database(db_path) as db:
            first_id = sorted(db.read_images())[0]
            kp = db.read_keypoints(first_id)
        stats = spatial_stats(kp if kp is not None else np.zeros((0, 2)),
                              args.width, args.height)

        row = run_stages(image_dir, db_path, vdir, cam_params, signed, device)
        row["extract_s"] = round(t_extract, 1)
        row["keypoint_dispersion"] = stats
        row["dispatch_rt_ms"] = dispatch_rt_ms(device)
        row["dispatch_rt_ms_before"] = rt0
        rows[variant] = row
        print(json.dumps({variant: row}), flush=True)

    out = {
        "metric": "bisect_rot_err_deg_asis",
        "value": rows.get("asis", {}).get("rot_err_deg"),
        "unit": "deg",
        "images": args.images,
        "weights": args.weights,
        "variants": rows,
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
