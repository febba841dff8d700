#!/usr/bin/env python
"""Exhaustive-matching benchmark (DTU-scale pair counts) on the PyTorch/CUDA
port.

Counterpart of ``scripts/bench_matching.py``, with its flags, defaults and
JSON keys: N images x K random unit descriptors (``default_rng(0)``), all
N(N-1)/2 pairs through ``ops/matching.get_pair_matcher()`` in chunks of
``--pair-batch`` pairs, the last chunk padded with pair (0, 0).  On the card
each chunk is one launch of the matching kernel (``match_topk2_colmax``):
126 launches at the defaults (64 x 4,096 x 128).  The descriptors stay on
the device, each chunk's rows are gathered there with ``index_select``, and
the clock stops after ``torch.cuda.synchronize()``.  ``device`` is the card's
name and power limit from ``nvidia-smi`` (or "cpu").  Random 128-wide unit
vectors are nearly orthogonal, so the matcher's distance test keeps few or
no matches: the benchmark times the matcher, not a match count.

    python3 scripts/torch_bench_matching.py --images 64 --keypoints 4096
    python3 scripts/torch_bench_matching.py --images 6 --keypoints 256 --device cpu

Without CUDA and without ``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def make_descriptors(images: int, keypoints: int, dim: int, device):
    """The JAX script's descriptors: ``default_rng(0)`` normals, normalized
    with ``ops/interpolate.l2_normalize``, on ``device``; and the
    all-valid mask."""
    import torch

    from vit_colmap_tpu_torch.ops.interpolate import l2_normalize

    rng = np.random.default_rng(0)
    raw = rng.standard_normal((images, keypoints, dim)).astype(np.float32)
    desc = l2_normalize(torch.from_numpy(raw)).to(device)
    return desc, torch.ones((images, keypoints), dtype=torch.bool, device=device)


def pair_chunks(images: int, pair_batch: int) -> np.ndarray:
    """(chunks, pair_batch, 2) int64: every pair (i < j) in order, the last
    chunk padded with pair (0, 0)."""
    pairs = [(i, j) for i in range(images) for j in range(i + 1, images)]
    pad = -len(pairs) % pair_batch
    return np.asarray(pairs + [(0, 0)] * pad, np.int64).reshape(-1, pair_batch, 2)


def match_all(match_pairs, desc, valid, chunks: np.ndarray):
    """Every chunk through ``match_pairs`` (the timed loop): the list of
    (pair_batch, K) match tensors, not yet synchronized."""
    import torch

    idx = torch.from_numpy(chunks).to(desc.device)
    outs = []
    for c in range(idx.shape[0]):
        ii, jj = idx[c, :, 0], idx[c, :, 1]
        outs.append(match_pairs(desc.index_select(0, ii), desc.index_select(0, jj),
                                valid.index_select(0, ii), valid.index_select(0, jj)))
    return outs


def synchronize(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def bench(images: int = 64, keypoints: int = 4096, dim: int = 128, pair_batch: int = 16,
          device=None, before_timed=None) -> dict:
    """The benchmark: a warm-up chunk of pair (0, 0), then every pair timed.
    ``before_timed()``, where given, runs just before the clock starts.
    Returns the JSON line's fields and, under ``"outs"`` and ``"chunks"``,
    the timed loop's matches and pairs."""
    from scripts.torch_eval_hpatches import device_label
    from vit_colmap_tpu_torch.device import resolve_device
    from vit_colmap_tpu_torch.ops.matching import get_pair_matcher

    label = device_label(device)  # raises without CUDA unless device is "cpu"
    device = resolve_device(device)
    match_pairs = get_pair_matcher()
    desc, valid = make_descriptors(images, keypoints, dim, device)
    chunks = pair_chunks(images, pair_batch)
    match_all(match_pairs, desc, valid, np.zeros((1, pair_batch, 2), np.int64))
    synchronize(device)
    if before_timed is not None:
        before_timed()

    t0 = time.perf_counter()
    outs = match_all(match_pairs, desc, valid, chunks)
    synchronize(device)
    dt = time.perf_counter() - t0
    num_pairs = images * (images - 1) // 2
    return {
        "metric": "exhaustive_match_pairs_per_sec",
        "value": round(num_pairs / dt, 1),
        "unit": "pairs/s",
        "num_pairs": num_pairs,
        "keypoints": keypoints,
        "seconds": round(dt, 3),
        "device": label,
        "outs": outs,
        "chunks": chunks,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--images", type=int, default=64)
    ap.add_argument("--keypoints", type=int, default=4096)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--pair-batch", type=int, default=16)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    out = bench(args.images, args.keypoints, args.dim, args.pair_batch, args.device)
    print(json.dumps({k: v for k, v in out.items() if k not in ("outs", "chunks")}))
    return out


if __name__ == "__main__":
    main()
