#!/usr/bin/env python
"""HPatches matching evaluation on the PyTorch/CUDA port: MMA and homography
accuracy per extractor.

Counterpart of ``scripts/eval_hpatches.py``, with its flags, defaults and
JSON keys, plus ``--device`` and the ``device`` key (the card's name and
power limit, or "cpu").  The extractor is built once and features are
cached per unique image (sha1 of its bytes), so shared reference images are
not extracted again.  The vit extractor fits its PCA on the first image it
extracts, as the JAX package's does, so its features depend on the order of
evaluation, which is the dataset's.  Mutual matches come from the port's
``get_pair_matcher()`` on a batch of one pair: on the card the matching
kernel (``match_topk2_colmax``) computes each pair.

    python3 scripts/torch_eval_hpatches.py --data-dir /path/to/hpatches \\
        --extractor sift --split viewpoint --max-pairs 100          # the card
    python3 scripts/torch_eval_hpatches.py --data-dir DIR --device cpu ...

Without CUDA and without ``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def make_extract_fn(extractor_name, backbone="vitb14", weights=None,
                    max_kp=2048, contrast_thresh=0.02, pca_path=None, device=None):
    """Build a single-image feature closure: (H, W, 3) uint8 RGB ->
    (kpts Nx2 float32, desc NxD uint8, encoding str)."""
    from vit_colmap_tpu_torch.device import resolve_device
    from vit_colmap_tpu_torch.models.dinov2 import PATCH_SIZE, patch_grid_size
    from vit_colmap_tpu_torch.utils.image_io import resize_linear, rgb_to_gray

    device = resolve_device(device)

    if extractor_name in ("sift", "colmap_sift"):
        from vit_colmap_tpu_torch.ops.sift import extract_sift

        def fn(img):
            gray = rgb_to_gray(img).astype(np.float32) / 255
            kp, dc = extract_sift(gray[None], max_keypoints=max_kp,
                                  contrast_thresh=contrast_thresh, device=device)
            return kp[0][:, :2], dc[0], "unsigned"

        return fn

    if extractor_name == "vit":
        from vit_colmap_tpu_torch.features.vit_extractor import ViTExtractor

        ex = ViTExtractor(weights_path=weights, backbone=backbone, max_keypoints=max_kp,
                          image_batch=1, pca_path=pca_path, device=device)

        def fn(img):
            oh, ow = img.shape[:2]
            th, tw = patch_grid_size(oh, ow)
            batch = resize_linear(img, tw, th)[None]
            xy, sc, valid, desc = ex.extract_batch(batch)
            v = valid[0]
            kp = ex._map_coords(xy[0][v], (tw, th), (ow, oh))
            return kp, desc[0][v], "signed"

        return fn

    if extractor_name == "trainable_vit":
        from vit_colmap_tpu_torch.features.trainable_vit_extractor import (
            TrainableViTExtractor,
        )

        ex = TrainableViTExtractor(weights_path=weights, backbone=backbone,
                                   num_keypoints=max_kp, image_batch=1, device=device)

        def fn(img):
            oh, ow = img.shape[:2]
            th, tw = patch_grid_size(oh, ow)
            batch = resize_linear(img, tw, th)[None]
            x, y, orient, score, valid, desc = ex.extract_batch(batch)
            v = valid[0]
            kp = np.stack([x[0][v] * ow / tw, y[0][v] * oh / th], axis=1).astype(np.float32)
            return kp, desc[0][v], "signed"

        return fn

    if extractor_name == "dummy":
        from vit_colmap_tpu_torch.features.dummy_extractor import dummy_features

        def fn(img):
            h, w = img.shape[:2]
            kp, dc = dummy_features(42, h, w, device=device)
            return kp.cpu().numpy(), dc.cpu().numpy(), "unsigned"

        return fn

    if extractor_name == "hybrid":
        from vit_colmap_tpu_torch.features.hybrid_extractor import HybridExtractor

        ex = HybridExtractor(weights_path=weights, backbone=backbone, max_keypoints=max_kp,
                             image_batch=1, pca_path=pca_path, device=device)

        def fn(img):
            oh, ow = img.shape[:2]
            th, tw = patch_grid_size(oh, ow)
            # The detector's keypoints, strongest first, cut to max_kp.
            pts = ex.detect(rgb_to_gray(img)).astype(np.float32).reshape(-1, 2)
            if len(pts) == 0:
                return pts, np.zeros((0, ex.descriptor_dim), np.uint8), "signed"
            fmap = ex._dense_features(resize_linear(img, tw, th)[None])
            gx = pts[:, 0] * (tw / ow) / PATCH_SIZE - 0.5
            gy = pts[:, 1] * (th / oh) / PATCH_SIZE - 0.5
            desc = ex.describe(fmap, np.stack([gx, gy], 1)[None])[0]
            return pts, desc, "signed"

        return fn

    raise ValueError(f"Unknown extractor {extractor_name!r}")


def mutual_match(f1, f2, device=None, matcher=None):
    """Mutual nearest-neighbour matches (R, 2) int64 of two feature triples:
    both sides zero-padded to max(N1, N2) rows with validity masks, through
    ``matcher`` (default ``get_pair_matcher()``) on a batch of one pair."""
    import torch

    from vit_colmap_tpu_torch.device import resolve_device
    from vit_colmap_tpu_torch.ops.interpolate import l2_normalize
    from vit_colmap_tpu_torch.ops.matching import compact_matches, get_pair_matcher

    (k1, d1, enc), (k2, d2, _) = f1, f2
    if len(k1) == 0 or len(k2) == 0:
        return np.zeros((0, 2), np.int64)
    dev = resolve_device(device)
    n = max(len(d1), len(d2))

    def prep(d):
        x = d.astype(np.float32)
        if enc == "signed":
            x = x / 127.5 - 1.0
        dp = np.zeros((n, x.shape[1]), np.float32)
        dp[: len(x)] = x
        v = np.zeros(n, bool)
        v[: len(x)] = True
        return (l2_normalize(torch.from_numpy(dp).to(dev))[None],
                torch.from_numpy(v).to(dev)[None])

    d1p, v1 = prep(d1)
    d2p, v2 = prep(d2)
    idx = (matcher or get_pair_matcher())(d1p, d2p, v1, v2)[0].cpu().numpy()
    return compact_matches(idx, len(d1)).astype(np.int64)


def evaluate_dataset(ds, extract_fn, max_pairs=None, thresholds=(1.0, 3.0, 5.0),
                     device=None):
    """Run the eval protocol over an HPatchesDataset with feature caching;
    returns (HomographyEvalResult, pairs per second)."""
    from vit_colmap_tpu_torch.utils.homography_eval import evaluate_pairs

    n = len(ds) if max_pairs is None else min(len(ds), max_pairs)
    cache: dict[str, tuple] = {}

    def features(img):
        key = hashlib.sha1(img.tobytes()).hexdigest()
        if key not in cache:
            cache[key] = extract_fn(img)
        return cache[key]

    t0 = time.perf_counter()
    pair_data = []
    for i in range(n):
        item = ds[i]
        f1 = features(item["image1"])
        f2 = features(item["image2"])
        matches = mutual_match(f1, f2, device)
        h, w = item["image1"].shape[:2]
        pair_data.append({"kpts1": f1[0], "kpts2": f2[0], "matches": matches,
                          "H": item["H"], "image_wh": (w, h)})
    result = evaluate_pairs(pair_data, thresholds, device=device)
    dt = time.perf_counter() - t0
    return result, n / dt


def device_label(device) -> str:
    """The card's name and power limit (nvidia-smi), or the device's type."""
    from scripts.torch_bench_reconstruction import card_name_and_limit
    from vit_colmap_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    return card_name_and_limit() if dev.type == "cuda" else dev.type


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-dir", type=Path, required=True)
    ap.add_argument("--extractor", default="sift",
                    choices=["sift", "colmap_sift", "vit", "trainable_vit", "hybrid"])
    ap.add_argument("--backbone", default="vitb14")
    ap.add_argument("--weights", type=Path, default=None)
    ap.add_argument("--pca-path", type=Path, default=None)
    ap.add_argument("--split", default="all")
    ap.add_argument("--pair-mode", default="reference_only")
    ap.add_argument("--max-pairs", type=int, default=None)
    ap.add_argument("--max-keypoints", type=int, default=2048)
    ap.add_argument("--contrast-thresh", type=float, default=0.02)
    ap.add_argument("--target-height", type=int, default=480)
    ap.add_argument("--target-width", type=int, default=640)
    ap.add_argument("--output", type=Path, default=None)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    from vit_colmap_tpu_torch.dataloader.hpatches_dataset import HPatchesDataset

    label = device_label(args.device)  # raises without CUDA unless --device cpu
    ds = HPatchesDataset(args.data_dir, split=args.split, pair_mode=args.pair_mode,
                         target_height=args.target_height, target_width=args.target_width)
    extract_fn = make_extract_fn(
        args.extractor, args.backbone, str(args.weights) if args.weights else None,
        args.max_keypoints, args.contrast_thresh,
        str(args.pca_path) if args.pca_path else None, device=args.device,
    )
    n = len(ds) if args.max_pairs is None else min(len(ds), args.max_pairs)
    print(f"Evaluating {args.extractor} on {n} pairs...")
    result, pairs_per_sec = evaluate_dataset(ds, extract_fn, args.max_pairs,
                                             device=args.device)
    print(result.summary())
    print(f"throughput: {pairs_per_sec:.2f} pairs/s (extract+match+eval)")

    if args.output:
        args.output.parent.mkdir(parents=True, exist_ok=True)
        with open(args.output, "w") as f:
            json.dump(
                {
                    "extractor": args.extractor,
                    "pairs": len(result.pairs),
                    "avg_matches": result.avg_matches,
                    "mma": {str(k): v for k, v in result.mma.items()},
                    "homography_accuracy": {
                        str(k): v for k, v in result.homography_accuracy.items()
                    },
                    "pairs_per_sec": pairs_per_sec,
                    "device": label,
                },
                f,
                indent=2,
            )
        print(f"Wrote {args.output}")


if __name__ == "__main__":
    main()
