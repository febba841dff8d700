"""Training CLI for the keypoint / descriptor heads.

Counterpart of ``vit_colmap_tpu/training/train.py``, with its flags and
defaults: AdamW with warmup-cosine (to lr / 100) and global-norm clip 1.0,
a random 90/10 train / validation split, per-batch error skipping (an epoch
in which every batch fails aborts), ``scalars.jsonl`` logging, checkpoints
``latest`` (full state, for ``--resume``) every ``--latest-every`` epochs,
``checkpoint_epoch_NNNN`` every ``--save-interval`` epochs and
``best_model`` (parameters only) on each new best validation loss, and
``meta.json`` ({epoch, step, train_backbone}) written after ``latest`` is on
disk.  ``--synthetic-only`` trains on generated pairs without a dataset,
and ``--train-backbone`` fine-tunes the backbone with the heads (the dense
token loss joins the total).

Port differences: one device (``--device``, the card unless ``cpu`` is
given); checkpoints are directories holding ``state.pt``
(``training/checkpoint.py``), not orbax; ``--backbone-weights`` takes a
torch DINOv2 ``.pth`` as before.  Each ``train`` line of ``scalars.jsonl``
also carries ``step_s``, the step's seconds on the host clock from its
start to its loss on the host.

Usage: ``python -m vit_colmap_tpu_torch.training.train --data-dir <hpatches> ...``
"""

from __future__ import annotations

import argparse
import itertools
import json
import logging
import os
import time
from pathlib import Path
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Train ViT feature heads (PyTorch)")
    # Data
    ap.add_argument("--data-dir", type=Path, default=None, help="HPatches root")
    ap.add_argument("--split", default="all",
                    choices=["all", "illumination", "viewpoint", "train", "test"])
    ap.add_argument("--pair-mode", default="all_pairs",
                    choices=["reference_only", "consecutive", "all_pairs"])
    ap.add_argument("--target-height", type=int, default=1200)
    ap.add_argument("--target-width", type=int, default=1600)
    ap.add_argument("--synthetic-ratio", type=float, default=0.5)
    ap.add_argument("--synthetic-preset", default="moderate",
                    choices=["conservative", "moderate", "aggressive"])
    ap.add_argument("--synthetic-only", action="store_true",
                    help="Train on generated image pairs (no dataset needed)")
    ap.add_argument("--photometric-strength", type=float, default=0.5,
                    help="brightness/contrast/gamma/noise jitter on img2 "
                         "(p=0.5 per sample; 0 = reference's geometric-only "
                         "pairs)")
    ap.add_argument("--synthetic-image-size", type=int, default=224,
                    help="Image side for --synthetic-only batches")
    ap.add_argument("--val-fraction", type=float, default=0.1)
    # Model
    ap.add_argument("--backbone", default="vitb14")
    ap.add_argument("--backbone-weights", type=Path, default=None)
    ap.add_argument("--descriptor-dim", type=int, default=128)
    ap.add_argument("--train-backbone", action="store_true",
                    help="Fine-tune the backbone jointly with the heads "
                    "(checkpoints then embed the backbone)")
    ap.add_argument("--backbone-lr-scale", type=float, default=0.1,
                    help="Backbone LR = lr * this (with --train-backbone)")
    # Optimization
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--weight-decay", type=float, default=1e-4)
    ap.add_argument("--warmup-steps", type=int, default=100)
    ap.add_argument("--grad-clip", type=float, default=1.0)
    ap.add_argument("--steps-per-epoch", type=int, default=None,
                    help="Cap steps per epoch (synthetic-only default 50)")
    # Loss
    ap.add_argument("--lambda-det", type=float, default=1.0)
    ap.add_argument("--lambda-desc", type=float, default=1.0)
    ap.add_argument("--alpha-orient", type=float, default=0.32)
    ap.add_argument("--margin", type=float, default=0.5)
    ap.add_argument("--temperature", type=float, default=0.1,
                    help="InfoNCE softmax temperature")
    ap.add_argument("--lambda-nce", type=float, default=1.0,
                    help="InfoNCE weight (anti-collapse)")
    ap.add_argument("--lambda-var", type=float, default=1.0,
                    help="descriptor variance-hinge weight (anti-collapse)")
    ap.add_argument("--lambda-token", type=float, default=1.0,
                    help="dense raw-token InfoNCE weight (--train-backbone "
                         "only): supervises the patch tokens the frozen "
                         "ViTExtractor consumes")
    ap.add_argument("--pos-weight", type=float, default=None,
                    help="detector BCE positive weight (default: dynamic)")
    ap.add_argument("--top-k", type=int, default=512)
    ap.add_argument("--structure-alpha", type=float, default=1.0,
                    help="image-cornerness prior blended into invariant-"
                         "point selection (0 = reference's pure feature-"
                         "similarity selection)")
    ap.add_argument("--num-in-image-neg", type=int, default=8)
    ap.add_argument("--num-cross-neg", type=int, default=4)
    ap.add_argument("--num-hard-neg", type=int, default=4)
    # Checkpointing / logging
    ap.add_argument("--output-dir", type=Path, default=Path("checkpoints"))
    ap.add_argument("--save-interval", type=int, default=1, help="epochs")
    ap.add_argument("--latest-every", type=int, default=1,
                    help="epochs between 'latest' full-state saves (the "
                    "final epoch always saves)")
    ap.add_argument("--resume", type=Path, default=None)
    ap.add_argument("--log-interval", type=int, default=10, help="steps")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain versions)")
    ap.add_argument("--verbose", "-v", action="store_true")
    return ap


def _synthetic_batches(batch_size, h, w, steps, preset, seed, photometric=0.0):
    """Generated-pair stream for --synthetic-only runs: random quarter-size
    noise upscaled with the port's INTER_CUBIC (``resize_cubic``, rounded
    to uint8), warped by a random homography."""
    from vit_colmap_tpu_torch.dataloader.synthetic_benchmark import resize_cubic
    from vit_colmap_tpu_torch.dataloader.synthetic_homography import (
        SyntheticHomographyConfig,
        create_synthetic_pair,
        photometric_jitter,
    )

    cfg = SyntheticHomographyConfig.preset(preset)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        im1 = np.zeros((batch_size, h, w, 3), np.uint8)
        im2 = np.zeros((batch_size, h, w, 3), np.uint8)
        Hs = np.zeros((batch_size, 3, 3), np.float32)
        for b in range(batch_size):
            base = rng.integers(0, 255, (h // 4, w // 4, 3), dtype=np.uint8)
            img = np.clip(np.rint(resize_cubic(base.astype(np.float32), w, h)), 0, 255)
            img = img.astype(np.uint8)
            warped, H = create_synthetic_pair(img, cfg, rng)
            if photometric > 0 and rng.random() < 0.5:
                warped = photometric_jitter(warped, rng, photometric)
            im1[b], im2[b], Hs[b] = img, warped, H
        yield {"image1": im1, "image2": im2, "H": Hs}


def prefetch(iterator, depth: int = 2):
    """Run an iterator in a background thread with a bounded queue, so host
    batch construction overlaps the device step.  An exception of the
    iterator is raised again here, after the items before it."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _END = object()
    errors: list = []

    def worker():
        try:
            for item in iterator:
                q.put(item)
        except Exception as e:  # raised again in the consumer
            errors.append(e)
        finally:
            q.put(_END)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is _END:
            if errors:
                raise errors[0]
            return
        yield item


class ScalarLogger:
    """Structured JSONL scalar sink (one line per event)."""

    def __init__(self, path: Path):
        path.parent.mkdir(parents=True, exist_ok=True)
        self.f = open(path, "a")

    def log(self, **scalars) -> None:
        self.f.write(json.dumps({k: _py(v) for k, v in scalars.items()}) + "\n")
        self.f.flush()

    def close(self):
        self.f.close()


def _py(v):
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    if hasattr(v, "item") and getattr(v, "ndim", 1) == 0:  # 0-d array or tensor
        return float(v)
    return v


def _write_json(path: Path, obj) -> None:
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_text(json.dumps(obj))
    os.replace(tmp, path)


def main(argv: Optional[list[str]] = None) -> None:
    args = build_argparser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="[%(asctime)s][%(filename)s:%(lineno)d][%(levelname)s] %(message)s",
        datefmt="%H:%M:%S",
    )

    import torch

    from vit_colmap_tpu_torch.dataloader.hpatches_dataset import patch_aligned, stack_items
    from vit_colmap_tpu_torch.device import resolve_device
    from vit_colmap_tpu_torch.models.dinov2 import make_backbone
    from vit_colmap_tpu_torch.models.feature_model import (
        FeatureHeads,
        FeatureModelConfig,
        count_parameters,
        reset_heads,
    )
    from vit_colmap_tpu_torch.training.checkpoint import load_checkpoint, save_checkpoint
    from vit_colmap_tpu_torch.training.train_step import (
        init_train_state,
        make_finetune_optimizer,
        make_optimizer,
        make_train_step,
    )

    device = resolve_device(args.device)
    logger.info("Device: %s", device)

    # ----------------------------------------------------------------- data
    if args.synthetic_only or args.data_dir is None:
        if args.data_dir is None and not args.synthetic_only:
            logger.warning("--data-dir not given; falling back to --synthetic-only")
        h = w = patch_aligned(args.synthetic_image_size)
        steps_per_epoch = args.steps_per_epoch or 50

        def train_stream(epoch):
            return _synthetic_batches(args.batch_size, h, w, steps_per_epoch,
                                      args.synthetic_preset, args.seed + epoch,
                                      photometric=args.photometric_strength)

        def val_stream():
            return _synthetic_batches(args.batch_size, h, w, max(steps_per_epoch // 10, 2),
                                      args.synthetic_preset, 10_000)
    else:
        from vit_colmap_tpu_torch.dataloader.hpatches_dataset import (
            HPatchesDataset,
            train_val_split,
        )
        from vit_colmap_tpu_torch.dataloader.synthetic_homography import (
            SyntheticHomographyConfig,
        )

        dataset = HPatchesDataset(
            args.data_dir,
            split=args.split,
            pair_mode=args.pair_mode,
            target_height=args.target_height,
            target_width=args.target_width,
            synthetic_ratio=args.synthetic_ratio,
            synthetic_config=SyntheticHomographyConfig.preset(args.synthetic_preset),
            photometric_strength=args.photometric_strength,
            seed=args.seed,
        )
        train_idx, val_idx = train_val_split(dataset, args.val_fraction, args.seed)
        steps_per_epoch = args.steps_per_epoch or max(len(train_idx) // args.batch_size, 1)

        def _stream(indices, shuffle_seed):
            order = np.array(indices)
            np.random.default_rng(shuffle_seed).shuffle(order)
            B = args.batch_size
            for s in range(0, len(order) - B + 1, B):
                items = []
                for i in order[s : s + B]:
                    try:
                        items.append(dataset[int(i)])
                    except Exception as e:  # skip unreadable samples
                        logger.warning("Skipping sample %d: %s", i, e)
                if len(items) < B:
                    continue
                yield stack_items(items)

        def train_stream(epoch):
            # --steps-per-epoch bounds the epoch: the schedule's length is
            # counted from it.  A new shuffle each epoch covers the split.
            return itertools.islice(_stream(train_idx, args.seed + epoch), steps_per_epoch)

        def val_stream():
            return _stream(val_idx, 10_000)

    # ---------------------------------------------------------------- model
    # Neither setting reaches the inference-only fixed-max kernels: "auto"
    # is PyTorch's fused attention on the card, which has a backward pass.
    backbone, bcfg = make_backbone(args.backbone, attn_impl="auto",
                                   generator=torch.Generator().manual_seed(args.seed))
    if args.backbone_weights:
        from vit_colmap_tpu_torch.models.convert import load_torch_checkpoint

        missing, unexpected = backbone.load_state_dict(
            load_torch_checkpoint(str(args.backbone_weights)), strict=False)
        if missing:
            raise ValueError(f"{args.backbone_weights} lacks backbone keys {missing}")
        if unexpected:  # e.g. the public checkpoints' mask_token
            logger.warning("Ignoring checkpoint keys %s", unexpected)
        logger.info("Loaded backbone weights from %s", args.backbone_weights)
    heads = FeatureHeads(FeatureModelConfig(backbone=args.backbone,
                                            descriptor_dim=args.descriptor_dim),
                         bcfg.embed_dim)
    reset_heads(heads, torch.Generator().manual_seed(args.seed))
    backbone.to(device)
    heads.to(device)
    logger.info("Trainable parameters: %s", f"{count_parameters(heads):,}")

    total_steps = args.epochs * steps_per_epoch
    if args.train_backbone:
        optimizer = make_finetune_optimizer(
            args.lr, args.weight_decay, total_steps, args.warmup_steps, args.grad_clip,
            backbone_lr_scale=args.backbone_lr_scale)
        trainable = torch.nn.ModuleDict({"heads": heads, "backbone": backbone})
        logger.info("Fine-tuning backbone (lr scale %.3g)", args.backbone_lr_scale)
    else:
        optimizer = make_optimizer(args.lr, args.weight_decay, total_steps,
                                   args.warmup_steps, args.grad_clip)
        backbone.eval().requires_grad_(False)
        trainable = heads
    state = init_train_state(trainable, optimizer)
    step_fn, eval_fn = make_train_step(
        backbone,
        heads,
        optimizer,
        train_backbone=args.train_backbone,
        loss_kwargs=dict(
            lambda_det=args.lambda_det,
            lambda_desc=args.lambda_desc,
            alpha_orient=args.alpha_orient,
            margin=args.margin,
            temperature=args.temperature,
            lambda_nce=args.lambda_nce,
            lambda_var=args.lambda_var,
            lambda_token=args.lambda_token,
            pos_weight=args.pos_weight,
        ),
        batch_kwargs=dict(
            top_k=args.top_k,
            num_in_image=args.num_in_image_neg,
            num_cross=args.num_cross_neg,
            num_hard=args.num_hard_neg,
            structure_alpha=args.structure_alpha,
        ),
    )

    # ---------------------------------------------------------- checkpoints
    out_dir = args.output_dir.resolve()
    out_dir.mkdir(parents=True, exist_ok=True)
    start_epoch = 0
    if args.resume:
        ckpt = load_checkpoint(args.resume)
        if "optimizer" not in ckpt:
            raise SystemExit(
                f"--resume {args.resume} is not a full-state checkpoint "
                "(best_model is params-only; resume from 'latest' or a "
                "checkpoint_epoch_NNNN instead)")
        try:
            heads.load_state_dict(ckpt["heads"])
            if args.train_backbone:
                backbone.load_state_dict(ckpt["backbone"])
            state.load_state_dict(ckpt)
        except (KeyError, RuntimeError, ValueError) as e:
            raise SystemExit(f"--resume {args.resume} does not match this run's "
                             f"model or optimizer: {e}") from e
        meta_path = Path(args.resume).resolve().parent / "meta.json"
        if meta_path.exists():
            start_epoch = json.loads(meta_path.read_text()).get("epoch", 0)
        logger.info("Resumed from %s at step %d", args.resume, state.step)

    def save(name: str, epoch: int, params_only: bool = False):
        """Write a checkpoint; ``latest`` then advances ``meta.json``, which
        so never runs ahead of a state on disk."""
        save_checkpoint(out_dir / name, heads, backbone if args.train_backbone else None,
                        None if params_only else state)
        if name == "latest":
            _write_json(out_dir / "meta.json",
                        {"epoch": epoch, "step": state.step,
                         "train_backbone": bool(args.train_backbone)})

    scalars = ScalarLogger(out_dir / "scalars.jsonl")

    def to_device(batch):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device, non_blocking=True)
                for k, v in batch.items()}

    # ------------------------------------------------------------ train loop
    best_val = float("inf")
    generator = torch.Generator(device=device).manual_seed(args.seed + 1)
    for epoch in range(start_epoch, args.epochs):
        t0 = time.perf_counter()
        losses = []
        attempted = 0
        for i, batch in enumerate(prefetch(train_stream(epoch))):
            attempted += 1
            try:
                ts = time.perf_counter()
                state, metrics = step_fn(state, to_device(batch), generator)
                loss = float(metrics["total_loss"])
                step_s = time.perf_counter() - ts
                losses.append(loss)
                if i % args.log_interval == 0:
                    scalars.log(event="train", epoch=epoch, step=state.step, step_s=step_s,
                                **{k: float(v) for k, v in metrics.items()})
                    logger.info("epoch %d step %d loss %.4f (det %.4f desc %.4f) %.3f s",
                                epoch, state.step, loss, float(metrics["detector_loss"]),
                                float(metrics["descriptor_loss"]), step_s)
            except Exception:
                logger.exception("Batch failed; continuing")  # reference parity
                continue
        dt = time.perf_counter() - t0
        n_steps = len(losses)
        logger.info("epoch %d done: %d steps, %.2f s/step, mean loss %.4f",
                    epoch, n_steps, dt / max(n_steps, 1), float(np.mean(losses or [0])))
        # Per-batch skipping is for transient failures; an epoch in which
        # every batch failed is a systematic breakage.
        if n_steps == 0 and attempted > 0:
            raise RuntimeError(f"epoch {epoch}: all {attempted} batches failed — aborting "
                               "(see logged exceptions above)")

        val_losses = []
        for batch in prefetch(val_stream()):
            m = eval_fn(state, to_device(batch), generator)
            val_losses.append(float(m["total_loss"]))
        val_loss = float(np.mean(val_losses)) if val_losses else float("inf")
        scalars.log(event="val", epoch=epoch, step=state.step, total_loss=val_loss)
        logger.info("epoch %d val loss %.4f", epoch, val_loss)

        if (epoch + 1) % args.latest_every == 0 or epoch + 1 == args.epochs:
            save("latest", epoch + 1)
        if (epoch + 1) % args.save_interval == 0:
            save(f"checkpoint_epoch_{epoch + 1:04d}", epoch + 1)
        if val_loss < best_val:
            best_val = val_loss
            save("best_model", epoch + 1, params_only=True)
            logger.info("new best model (val %.4f)", val_loss)

    scalars.close()
    logger.info("Training complete. Checkpoints in %s", out_dir)


if __name__ == "__main__":
    main()
