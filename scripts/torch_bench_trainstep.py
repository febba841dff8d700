#!/usr/bin/env python
"""Training-step throughput benchmark on the PyTorch/CUDA port.

Counterpart of ``scripts/bench_trainstep.py``, with its flags, defaults and
JSON keys: the frozen backbone (random, seed 0) and the trainable heads go
through ``training/train_step.make_train_step`` with the optimizer of
``make_optimizer(3e-4, total_steps=1000)``, on one batch of random uint8
pairs (``default_rng(0)``) with identity homographies.  Two warm-up steps,
then ``--steps`` timed steps with one host read of the loss at the end; the
data pipeline is excluded, so this times the step alone.  Step ``k``
draws its samples from ``torch.Generator`` seeded ``k`` (1 and 2 for the
warm-ups, 3 + i for the timed steps), as the JAX script's ``key(k)``.

The keys keep the JAX script's names: ``compile_s`` is the first step's
seconds on the card (kernel selection, allocator growth, first launches;
nothing is compiled), and ``device`` is the card's name and power limit from
``nvidia-smi`` (or "cpu").  vitb14 at 476 x 644 is 1,565 tokens, so
``attn_impl="auto"`` takes PyTorch's fused attention on the card, which has
a backward pass, as the JAX step takes JAX's flash kernel.

``--check-repro`` runs the same sequence again from the same seeds and
adds ``repro``: whether every step's loss and the final heads are bit for
bit the benchmark's, and the largest differences.

    python3 scripts/torch_bench_trainstep.py [--batch-size 2] [--steps 20]
    python3 scripts/torch_bench_trainstep.py --backbone vits14 --height 112 \\
        --width 140 --steps 2 --top-k 32 --device cpu

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

LEARNING_RATE = 3e-4
TOTAL_STEPS = 1000


def make_batch(batch_size: int, height: int, width: int) -> dict:
    """The JAX script's batch in numpy: random uint8 pairs, identity H."""
    rng = np.random.default_rng(0)
    shape = (batch_size, height, width, 3)
    return {
        "image1": rng.integers(0, 256, shape, dtype=np.uint8),
        "image2": rng.integers(0, 256, shape, dtype=np.uint8),
        "H": np.broadcast_to(np.eye(3, dtype=np.float32), (batch_size, 3, 3)).copy(),
    }


def make_step(backbone, heads, top_k: int):
    """(state, step) over ``heads`` with ``backbone`` frozen, as the JAX
    script builds them."""
    from vit_colmap_tpu_torch.training.train_step import (
        init_train_state,
        make_optimizer,
        make_train_step,
    )

    optimizer = make_optimizer(LEARNING_RATE, total_steps=TOTAL_STEPS)
    backbone.eval().requires_grad_(False)
    state = init_train_state(heads, optimizer)
    step, _ = make_train_step(backbone, heads, optimizer, batch_kwargs=dict(top_k=top_k))
    return state, step


def build(backbone_name: str, batch_size: int, height: int, width: int, top_k: int, device):
    """Random backbone and heads (seed 0) on ``device``, the state, the step
    and the batch on ``device``."""
    import torch

    from vit_colmap_tpu_torch.models.dinov2 import make_backbone
    from vit_colmap_tpu_torch.models.feature_model import (
        FeatureHeads,
        FeatureModelConfig,
        reset_heads,
    )

    backbone, bcfg = make_backbone(backbone_name, attn_impl="auto",
                                   generator=torch.Generator().manual_seed(0))
    heads = FeatureHeads(FeatureModelConfig(backbone=backbone_name), bcfg.embed_dim)
    reset_heads(heads, torch.Generator().manual_seed(0))
    backbone.to(device)
    heads.to(device)
    state, step = make_step(backbone, heads, top_k)
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in make_batch(batch_size, height, width).items()}
    return state, step, batch


def synchronize(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_steps(state, step, batch, keys, device):
    """One step a key, each drawing from ``torch.Generator`` seeded with
    it; the metrics of every step (tensors, not read)."""
    import torch

    metrics = []
    for k in keys:
        state, m = step(state, batch, torch.Generator(device=device).manual_seed(k))
        metrics.append(m)
    return state, metrics


def bench(backbone_name="vitb14", batch_size=2, height=476, width=644, steps=20, top_k=256,
          device=None) -> tuple[dict, dict]:
    """The benchmark's JSON fields, and the run as :func:`sequence` gives
    it: the losses of the 2 + ``steps`` steps and the final heads."""
    from scripts.torch_eval_hpatches import device_label
    from vit_colmap_tpu_torch.device import resolve_device

    label = device_label(device)  # raises without CUDA unless device is "cpu"
    device = resolve_device(device)
    state, step, batch = build(backbone_name, batch_size, height, width, top_k, device)

    t0 = time.perf_counter()
    state, first = run_steps(state, step, batch, [1], device)
    float(first[0]["total_loss"])
    compile_s = time.perf_counter() - t0
    state, second = run_steps(state, step, batch, [2], device)
    float(second[0]["total_loss"])

    t0 = time.perf_counter()
    state, timed = run_steps(state, step, batch, range(3, 3 + steps), device)
    final_loss = float(timed[-1]["total_loss"])
    synchronize(device)
    dt = time.perf_counter() - t0

    steps_per_sec = steps / dt
    out = {
        "metric": "train_steps_per_sec",
        "value": round(steps_per_sec, 4),
        "unit": "steps/s",
        "s_per_step": round(dt / steps, 4),
        "images_per_sec": round(steps_per_sec * 2 * batch_size, 3),
        "batch_size": batch_size,
        "image_size": [height, width],
        "backbone": backbone_name,
        "compile_s": round(compile_s, 1),
        "final_loss": final_loss,
        "device": label,
    }
    return out, on_host(state, first + second + timed)


def on_host(state, metrics) -> dict:
    """The losses of a run's steps and its final heads' parameters, on the
    host."""
    import torch

    return {"losses": torch.stack([m["total_loss"] for m in metrics]).cpu(),
            "heads": {k: v.detach().cpu().clone()
                      for k, v in state.heads_params.state_dict().items()}}


def sequence(backbone_name, batch_size, height, width, steps, top_k, device) -> dict:
    """The benchmark's 2 + ``steps`` steps without a clock, from a new
    build: :func:`on_host` of the run."""
    state, step, batch = build(backbone_name, batch_size, height, width, top_k, device)
    return on_host(*run_steps(state, step, batch, [1, 2, *range(3, 3 + steps)], device))


def compare_runs(a: dict, b: dict) -> dict:
    """Bit equality of two ``sequence`` results, and their largest
    differences."""
    import torch

    loss_diff = (a["losses"] - b["losses"]).abs()
    param_diff = {k: float((a["heads"][k].float() - b["heads"][k].float()).abs().max())
                  for k in a["heads"]}
    return {
        "bit_equal": bool(torch.equal(a["losses"], b["losses"])
                          and all(torch.equal(a["heads"][k], b["heads"][k]) for k in a["heads"])),
        "losses_equal": bool(torch.equal(a["losses"], b["losses"])),
        "first_step_loss_equal": bool(torch.equal(a["losses"][0], b["losses"][0])),
        "max_abs_loss_diff": float(loss_diff.max()),
        "max_abs_param_diff": max(param_diff.values()),
        "params_differing": sorted(k for k, v in param_diff.items() if v > 0),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backbone", default="vitb14")
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--height", type=int, default=476)
    ap.add_argument("--width", type=int, default=644)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--top-k", type=int, default=256)
    ap.add_argument("--check-repro", action="store_true",
                    help="run the step sequence again from the same seeds and compare")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    out, run = bench(args.backbone, args.batch_size, args.height, args.width, args.steps,
                     args.top_k, args.device)
    if args.check_repro:
        import torch

        again = sequence(args.backbone, args.batch_size, args.height, args.width, args.steps,
                         args.top_k, torch.device(args.device or "cuda"))
        out["repro"] = compare_runs(run, again)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
