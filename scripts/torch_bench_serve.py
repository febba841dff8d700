#!/usr/bin/env python
"""Serving-mode benchmark on the PyTorch/CUDA port: per-scene wall-clock in
one warm process.

Counterpart of ``scripts/bench_serve.py``, with its flags, defaults and JSON
keys: ``--scenes`` synthetic multi-view scenes of ``--images`` views (the
port's ``render_multiview_scene``, world seeds 11 + s, focal 0.94 x the
longer side) reconstructed one after another through ONE
``pipeline/serve.PipelineServer``.  Scene 1 pays the process's first-use
costs (the kernels' build or load, the extractor's model, allocator growth);
later scenes measure the warm serving cost.  On the card every matching
chunk is one launch of the matching kernel (``match_topk2_colmax``).
``platform`` is the card's name and power limit from ``nvidia-smi`` (or
"cpu"), where the JAX script names its backend.

Prints ONE JSON line:
  {"metric": "serve_scene_wall_s", "cold": ..., "warm_mean": ...,
   "amortization_x": cold/warm_mean, "scenes": [...per-scene reports]}

    python3 scripts/torch_bench_serve.py                    # the card
    python3 scripts/torch_bench_serve.py --tiny --device cpu

``--tiny`` is 2 scenes of 5 views at 126 x 168, 256 keypoints.  Without CUDA
and without ``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def scene_jobs(work: Path, scenes: int, images: int, height: int, width: int):
    """Render (or reuse) each scene under ``work/scene_<s>``: the jobs and
    the last scene's PINHOLE parameters."""
    from vit_colmap_tpu_torch.dataloader.synthetic_benchmark import render_multiview_scene
    from vit_colmap_tpu_torch.pipeline.serve import SceneJob

    jobs, cam_params = [], None
    for s in range(scenes):
        scene_dir = work / f"scene_{s}"
        image_dir = scene_dir / "images"
        if not image_dir.exists():
            _, K = render_multiview_scene(image_dir, n_cams=images, size=(height, width),
                                          focal=float(max(height, width)) * 0.94,
                                          seed=11 + s)
            (scene_dir / "camera.json").write_text(json.dumps(
                {"params": [K[0, 0], K[1, 1], K[0, 2], K[1, 2]]}))
        cam_params = json.loads((scene_dir / "camera.json").read_text())["params"]
        jobs.append(SceneJob(image_dir=image_dir, output_dir=scene_dir / "out"))
    return jobs, cam_params


def serve_config(extractor: str, max_keypoints: int, cam_params, skip_reconstruction: bool):
    from vit_colmap_tpu_torch.utils.config import Config

    config = Config()
    config.extractor.extractor_type = extractor
    config.extractor.max_keypoints = max_keypoints
    config.camera.model = "PINHOLE"
    config.camera.params = [float(p) for p in cam_params]
    config.do_reconstruction = not skip_reconstruction
    return config


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenes", type=int, default=3)
    ap.add_argument("--images", type=int, default=20)
    ap.add_argument("--extractor", default="sift")
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--max-keypoints", type=int, default=2048)
    ap.add_argument("--skip-reconstruction", action="store_true")
    ap.add_argument("--work-dir", type=Path, default=None)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    if args.tiny:
        args.scenes, args.images = 2, 5
        args.height, args.width, args.max_keypoints = 126, 168, 256

    from scripts.torch_eval_hpatches import device_label
    from vit_colmap_tpu_torch.pipeline.serve import PipelineServer

    label = device_label(args.device)  # raises without CUDA unless --device cpu
    work = args.work_dir or Path(tempfile.mkdtemp(prefix="torch_bench_serve_"))
    jobs, cam_params = scene_jobs(work, args.scenes, args.images, args.height, args.width)
    config = serve_config(args.extractor, args.max_keypoints, cam_params,
                          args.skip_reconstruction)

    server = PipelineServer(config, device=args.device)
    t0 = time.perf_counter()
    results = server.serve(jobs)
    total = time.perf_counter() - t0

    scenes = [r.to_dict() for r in results]
    walls = [r.wall_s for r in results if r.ok]
    cold = walls[0] if walls else float("nan")
    warm = walls[1:]
    warm_mean = sum(warm) / len(warm) if warm else float("nan")
    out = {
        "metric": "serve_scene_wall_s",
        "value": round(warm_mean, 3),
        "unit": "s/scene (warm)",
        "cold": round(cold, 3),
        "warm_mean": round(warm_mean, 3),
        "amortization_x": round(cold / warm_mean, 2) if warm else None,
        "total_s": round(total, 3),
        "n_scenes": args.scenes,
        "images_per_scene": args.images,
        "extractor": args.extractor,
        "platform": label,
        "scenes": scenes,
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
