#!/usr/bin/env python
"""The reference's 50-view reconstruction protocol on the PyTorch/CUDA port.

Counterpart of ``scripts/bench_reconstruction.py``: renders the synthetic
multi-view scene with the port's numpy renderer (50 views at 480 x 640,
seed 7, focal 0.94 x the longer side), runs the port's full pipeline
(extract -> match -> verify -> incremental mapping and bundle adjustment)
through ``Pipeline.run``, and prints ONE JSON line with the wall-clock,
the stage seconds of ``Pipeline.run``'s report and the reconstruction's
quality against the renderer's poses.

    python3 scripts/torch_bench_reconstruction.py                 # on the GPU
    python3 scripts/torch_bench_reconstruction.py --tiny --device cpu

``--tiny`` is a CPU-sized run: 6 views at 126 x 168, 256 keypoints.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def card_name_and_limit() -> str:
    """``nvidia-smi``'s name and power limit of the card, or why not."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({type(e).__name__})"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--images", type=int, default=50)
    ap.add_argument("--extractor", default="sift")
    ap.add_argument("--backbone", default="vitb14")
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--max-keypoints", type=int, default=2048)
    ap.add_argument("--weights", type=Path, default=None,
                    help="ViT backbone weights (torch .pth) for --extractor vit")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--work-dir", type=Path, default=None)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args()
    if args.tiny:
        args.images, args.height, args.width = 6, 126, 168
        args.max_keypoints, args.backbone = 256, "vits14"

    from vit_colmap_tpu_torch.dataloader.synthetic_benchmark import render_multiview_scene
    from vit_colmap_tpu_torch.pipeline import Pipeline
    from vit_colmap_tpu_torch.sfm.align import best_pose_errors, gt_poses_for_rendered_scene
    from vit_colmap_tpu_torch.utils.config import Config

    work = args.work_dir or Path(tempfile.mkdtemp(prefix="torch_bench_recon_"))
    image_dir = work / "images"
    t = time.perf_counter()
    if not image_dir.exists():
        _, K = render_multiview_scene(
            image_dir, n_cams=args.images, size=(args.height, args.width),
            focal=float(max(args.height, args.width)) * 0.94, seed=args.seed)
        (work / "camera.json").write_text(json.dumps(
            {"params": [K[0, 0], K[1, 1], K[0, 2], K[1, 2]]}))
    render_s = time.perf_counter() - t
    cam_params = json.loads((work / "camera.json").read_text())["params"]

    config = Config()
    config.extractor.extractor_type = args.extractor
    config.extractor.backbone = args.backbone
    config.extractor.max_keypoints = args.max_keypoints
    if args.weights:
        config.extractor.vit_weights_path = str(args.weights)
    config.camera.model = "PINHOLE"
    config.camera.params = [float(p) for p in cam_params]

    db_path = work / "db.db"
    if db_path.exists():
        db_path.unlink()
    pipe = Pipeline(config, device=args.device)
    t0 = time.perf_counter()
    report = pipe.run(image_dir, work / "out", db_path)
    wall = time.perf_counter() - t0

    registered = points3d = observations = 0
    reproj = track_mean = 0.0
    track_hist: dict[str, int] = {}
    pose = None
    if pipe.reconstructions:
        pose = best_pose_errors(pipe.reconstructions, gt_poses_for_rendered_scene(image_dir))
        registered = sum(len(r.images) for r in pipe.reconstructions.values())
        points3d = sum(len(r.points3D) for r in pipe.reconstructions.values())
        biggest = max(pipe.reconstructions.values(), key=lambda r: len(r.images))
        reproj = biggest.mean_reprojection_error()
        lens = [len(pt.track) for r in pipe.reconstructions.values()
                for pt in r.points3D.values()]
        observations = int(sum(lens))
        track_mean = float(sum(lens)) / max(len(lens), 1)
        for n in lens:
            b = str(n) if n < 8 else "8+"
            track_hist[b] = track_hist.get(b, 0) + 1

    stages = {"render": render_s}
    if report:
        stages.update({k: report[k] for k in ("extract_s", "match_s", "verify_s",
                                               "reconstruction_s") if k in report})
    print(json.dumps({
        "metric": "recon_wall_clock_s",
        "value": wall,
        "unit": "s",
        "num_images": args.images,
        "extractor": args.extractor,
        "registered_images": registered,
        "registration_rate": 100.0 * registered / args.images,
        "points3d": points3d,
        "observations": observations,
        "mean_track_length": track_mean,
        "track_length_hist": dict(sorted(track_hist.items())),
        "mean_reproj_error_px": reproj,
        "pose_rot_err_deg": pose["pose_rot_err_deg_mean"] if pose else None,
        "pose_rot_err_deg_max": pose["pose_rot_err_deg_max"] if pose else None,
        "pose_center_err_rel": pose["pose_center_err_rel_mean"] if pose else None,
        "pose_center_err_rel_max": pose["pose_center_err_rel_max"] if pose else None,
        "aligned_cameras": pose["aligned_cameras"] if pose else 0,
        "stage_s": stages,
        "verify_chunks": report.get("verify_chunks") if report else None,
        "resolution": f"{args.height}x{args.width}",
        "weights": str(args.weights) if args.weights else None,
        "device": str(pipe.device),
        "card": card_name_and_limit() if pipe.device.type == "cuda" else None,
    }))


if __name__ == "__main__":
    main()
