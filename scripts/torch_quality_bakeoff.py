#!/usr/bin/env python
"""Extractor quality bake-off on the PyTorch/CUDA port: sift vs vit vs
trainable_vit (optionally trained), on in-repo synthetic benchmarks.

Counterpart of ``scripts/quality_bakeoff.py``, with its flags, defaults,
``QUALITY.json`` and ``QUALITY.md``:

1. **HPatches protocol**: MMA@1/3/5 px, homography accuracy and average
   matches on a generated ``i_*``/``v_*`` tree (seed 0) and on a held-out
   tree that training never sees (seed 417), through
   ``scripts/torch_eval_hpatches.py``.
2. **Reconstruction protocol**: registered images, 3D points, track length,
   reprojection error, inlier ratio and the pose error against the
   renderer's poses on a rendered multi-view scene (seed 1), through the
   port's ``Pipeline``.
3. ``--train`` trains the trainable heads with the port's trainer
   (``--train-backbone`` also fine-tunes the backbone) and evaluates the
   trained rows.

Departures: ``--device`` (the card unless ``cpu``; without CUDA and without
``--device cpu`` it raises); ``meta.device`` is the card's name and power
limit from ``nvidia-smi`` (or "cpu"); the default ``--work-dir`` is
``results/quality_torch``; ``--weights`` takes a DINOv2 ``.pth`` for the
backbone of every ViT row (the trainable rows get it embedded beside their
heads in a trainer checkpoint directory, and training starts from it);
without it the backbone is the random init from a seed, as in the JAX
package's run.  Each row is written to ``QUALITY.json`` as soon as it is
measured, and rows of an earlier run in the same directory are kept.

    python3 scripts/torch_quality_bakeoff.py --extractors sift,vit,trainable_vit --train
    python3 scripts/torch_quality_bakeoff.py --fast --device cpu   # CPU-sized smoke run
    python3 scripts/torch_quality_bakeoff.py --md-only             # QUALITY.md again
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import asdict
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from scripts.torch_eval_hpatches import (  # noqa: E402
    device_label,
    evaluate_dataset,
    make_extract_fn,
)


def build_data(work: Path, args) -> tuple[Path, Path, list[float]]:
    from vit_colmap_tpu_torch.dataloader.synthetic_benchmark import (
        generate_synthetic_hpatches,
        render_multiview_scene,
    )

    hp_dir = work / "hpatches"
    if not hp_dir.exists():
        print(f"Generating synthetic HPatches tree at {hp_dir} ...")
        generate_synthetic_hpatches(
            hp_dir, n_illum=args.n_illum, n_view=args.n_view,
            n_img=args.n_img, size=(args.height, args.width), seed=0,
        )
    scene_dir = work / "scene" / "images"
    cam_file = work / "scene" / "camera.json"
    if not scene_dir.exists():
        print(f"Rendering multi-view scene at {scene_dir} ...")
        _, K = render_multiview_scene(
            scene_dir, n_cams=args.recon_cams,
            size=(args.height, args.width), focal=args.focal, seed=1,
        )
        cam_file.write_text(json.dumps({
            "model": "PINHOLE",
            "params": [K[0, 0], K[1, 1], K[0, 2], K[1, 2]],
        }))
    elif not (scene_dir / "gt_poses.json").exists():
        # A scene cached before the renderer wrote gt_poses.json: the render
        # is seed-pinned, so rendering it again into a temporary directory
        # reproduces the poses.  Only gt_poses.json is copied, and only if
        # the new render's first image equals the cached one byte for byte
        # (otherwise the arguments or the renderer changed since).
        print(f"Backfilling gt_poses.json for cached scene {scene_dir} ...")
        import shutil
        import tempfile

        with tempfile.TemporaryDirectory(prefix="gt_backfill_") as tmp:
            tmp_dir = Path(tmp) / "images"
            render_multiview_scene(
                tmp_dir, n_cams=args.recon_cams,
                size=(args.height, args.width), focal=args.focal, seed=1,
            )
            ref_img = next(iter(sorted(tmp_dir.glob("*.png"))), None)
            if ref_img is not None and (scene_dir / ref_img.name).exists():
                if ref_img.read_bytes() != (scene_dir / ref_img.name).read_bytes():
                    raise RuntimeError(
                        f"Backfill render of {ref_img.name} differs from the "
                        f"cached image — CLI args or renderer code drifted "
                        f"since the scene was cached; its gt_poses would not "
                        f"match the cached pixels. Delete {scene_dir} to "
                        f"re-render from scratch."
                    )
            shutil.copy2(tmp_dir / "gt_poses.json", scene_dir / "gt_poses.json")
    cam = json.loads(cam_file.read_text())
    return hp_dir, scene_dir, cam["params"]


def build_holdout(work: Path, args) -> Path:
    """A second synthetic HPatches tree that training never sees (another
    seed: other base content and other warps)."""
    from vit_colmap_tpu_torch.dataloader.synthetic_benchmark import (
        generate_synthetic_hpatches,
    )

    ho_dir = work / "hpatches_holdout"
    if not ho_dir.exists():
        print(f"Generating HELD-OUT synthetic HPatches tree at {ho_dir} ...")
        generate_synthetic_hpatches(
            ho_dir, n_illum=args.n_illum, n_view=args.n_view,
            n_img=args.n_img, size=(args.height, args.width), seed=417,
        )
    return ho_dir


def build_train_tree(work: Path, args) -> Path:
    """A larger synthetic tree used only for training (``--train-tree big``),
    with a seed of its own, so that both evaluation trees are unseen."""
    from vit_colmap_tpu_torch.dataloader.synthetic_benchmark import (
        generate_synthetic_hpatches,
    )

    tr_dir = work / "hpatches_train_big"
    if not tr_dir.exists():
        print(f"Generating BIG training tree at {tr_dir} ...")
        generate_synthetic_hpatches(
            tr_dir, n_illum=args.n_illum + 2, n_view=args.n_view + 2,
            n_img=args.n_img + 2, size=(args.height, args.width), seed=11,
        )
    return tr_dir


def with_backbone(heads_ckpt, weights: str, out: Path, backbone: str) -> str:
    """A trainer checkpoint directory ``out`` holding the heads of
    ``heads_ckpt`` (a trainer checkpoint directory; None: the trainable
    extractor's random heads) and the backbone of the ``.pth`` ``weights``:
    the trainable extractor loads both from it."""
    import torch

    from vit_colmap_tpu_torch.models.convert import load_torch_checkpoint
    from vit_colmap_tpu_torch.models.feature_model import make_feature_model
    from vit_colmap_tpu_torch.training.checkpoint import load_checkpoint, save_checkpoint

    # The random heads of TrainableViTExtractor(seed=0).
    model, _, _ = make_feature_model(backbone, norm="group",
                                     generator=torch.Generator().manual_seed(0))
    if heads_ckpt is not None:
        model.heads.load_state_dict(load_checkpoint(heads_ckpt)["heads"])
    missing, _ = model.backbone.load_state_dict(load_torch_checkpoint(weights), strict=False)
    if missing:
        raise ValueError(f"{weights} lacks backbone keys {missing}")
    save_checkpoint(out, model.heads, model.backbone)
    return str(out)


def eval_hpatches(hp_dir: Path, extractor: str, args, weights=None) -> dict:
    from vit_colmap_tpu_torch.dataloader.hpatches_dataset import HPatchesDataset

    ds = HPatchesDataset(
        hp_dir, split="all", pair_mode="reference_only",
        target_height=args.height, target_width=args.width,
    )
    fn = make_extract_fn(extractor, args.backbone, weights, args.max_keypoints,
                         device=args.device)
    result, pps = evaluate_dataset(ds, fn, args.max_pairs, device=args.device)
    print(f"[{extractor}] {result.summary()}")
    return {
        "pairs": len(result.pairs),
        "avg_matches": result.avg_matches,
        "mma": {str(k): v for k, v in result.mma.items()},
        "homography_accuracy": {
            str(k): v for k, v in result.homography_accuracy.items()
        },
        "pairs_per_sec": pps,
    }


def run_reconstruction(scene_dir: Path, extractor: str, args, cam_params,
                       weights=None, tag=None) -> dict:
    from vit_colmap_tpu_torch.pipeline import Pipeline
    from vit_colmap_tpu_torch.sfm.align import best_pose_errors, gt_poses_for_rendered_scene
    from vit_colmap_tpu_torch.utils.config import Config
    from vit_colmap_tpu_torch.utils.metrics import MetricsExtractor

    # ``tag`` names the output directory after the result row, not the
    # extractor: two rows run the trainable_vit extractor.
    out = scene_dir.parent / f"out_{tag or extractor}"
    db_path = out / "db.db"
    if db_path.exists():
        db_path.unlink()
    config = Config()
    config.extractor.extractor_type = extractor
    config.extractor.backbone = args.backbone
    config.extractor.max_keypoints = args.max_keypoints
    if weights:
        config.extractor.vit_weights_path = weights
    config.camera.model = "PINHOLE"
    config.camera.params = [float(p) for p in cam_params]
    t0 = time.perf_counter()
    pipe = Pipeline(config, device=args.device)
    pipe.run(scene_dir, out, db_path)
    wall = time.perf_counter() - t0
    me = MetricsExtractor(db_path, out)
    res = me.extract_all_metrics(
        "synthetic", "scene", extractor,
        reconstructions=pipe.reconstructions or None,
    )
    d = {
        "features": asdict(res.features),
        "matching": asdict(res.matching),
        "reconstruction": asdict(res.reconstruction) if res.reconstruction else None,
        "wall_clock_s": wall,
    }
    if d["reconstruction"]:
        d["reconstruction"].pop("reconstructions", None)
    # The rendered scene ships its exact poses.
    pose = best_pose_errors(pipe.reconstructions, gt_poses_for_rendered_scene(scene_dir))
    if pose:
        pose.pop("per_image", None)
        d["pose_vs_gt"] = pose
    print(f"[{extractor}] recon: {wall:.1f}s, "
          f"registered={res.reconstruction.registered_images if res.reconstruction else 0}, "
          f"points={res.reconstruction.total_3d_points if res.reconstruction else 0}, "
          + (f"rot_err={pose['pose_rot_err_deg_mean']:.3f}deg, "
             f"ctr_err={100 * pose['pose_center_err_rel_mean']:.2f}%"
             if pose else "pose_vs_gt=n/a"))
    return d


def train_heads(hp_dir: Path, work: Path, args) -> str:
    """Train the trainable head on the synthetic tree; returns the best
    checkpoint directory (``latest`` when there is no ``best_model``)."""
    from vit_colmap_tpu_torch.training.train import main as train_main

    ckpt_dir = work / (
        "checkpoints_bb" if getattr(args, "train_backbone", False)
        else "checkpoints"
    )
    # top_k invariant points must fit the token grid (H/14 * W/14).
    top_k = min(256, (args.height // 14) * (args.width // 14) // 2)
    # A ``latest`` checkpoint short of the target epoch count (an earlier
    # run that stopped) is resumed rather than trained again from scratch.
    resume: list[str] = []
    meta_path = ckpt_dir / "meta.json"
    latest = ckpt_dir / "latest"
    if latest.exists() and meta_path.exists():
        done_epochs = json.loads(meta_path.read_text()).get("epoch", 0)
        if done_epochs >= args.epochs:
            print(f"Training already complete ({done_epochs} epochs); reusing.")
            best = ckpt_dir / "best_model"
            return str(best if best.exists() else latest)
        resume = ["--resume", str(latest)]
        print(f"Resuming training from epoch {done_epochs}")
    argv = [
        "--data-dir", str(hp_dir),
        "--pair-mode", "all_pairs",
        "--target-height", str(args.height),
        "--target-width", str(args.width),
        "--backbone", args.backbone,
        "--epochs", str(args.epochs),
        "--batch-size", str(args.batch_size),
        "--steps-per-epoch", str(args.steps_per_epoch),
        "--lr", "3e-4",
        "--top-k", str(top_k),
        "--output-dir", str(ckpt_dir),
        "--synthetic-ratio", "0.3",
        "--photometric-strength", "0.5",
        "--seed", "0",
    ] + resume
    if args.weights:
        argv += ["--backbone-weights", str(args.weights)]
    if args.device:
        argv += ["--device", args.device]
    if getattr(args, "train_backbone", False):
        # Fine-tune states hold the backbone and its AdamW moments:
        # checkpoint sparsely.  From random init the backbone is trained,
        # not fine-tuned, and needs a real learning rate (the 0.1 scale
        # protects pretrained weights).
        argv += ["--train-backbone", "--latest-every", "4",
                 "--save-interval", "8",
                 "--backbone-lr-scale", str(args.backbone_lr_scale),
                 "--lambda-token", str(args.lambda_token)]
    print(f"Training trainable head: {' '.join(argv)}")
    train_main(argv)
    best = ckpt_dir / "best_model"
    return str(best if best.exists() else ckpt_dir / "latest")


def _weights_label(name: str) -> str:
    """The weights provenance of a row, shown in the table."""
    if name in ("sift", "dummy", "colmap_sift"):
        return "n/a (no model)"
    if name.endswith("_finetuned"):
        return "trained heads + FINE-TUNED backbone (from random init)"
    if name.endswith("_trained"):
        return "trained heads, RANDOM backbone"
    return "RANDOM backbone (untrained)"


def to_markdown(results: dict) -> str:
    lines = [
        "# Extractor quality bake-off (synthetic benchmarks)",
        "",
        f"Generated {time.strftime('%Y-%m-%d %H:%M')} on "
        f"{results['meta']['device']}; backbone {results['meta']['backbone']} "
        f"({results['meta']['weights_note']}).",
        ""
        if results["meta"].get("train_tree", "same") != "big"
        else "\nTrained rows were trained on a DEDICATED larger tree "
             "(seed 11): both evaluation trees below are unseen by "
             "training.\n",
        "",
        "No pretrained DINOv2 checkpoint exists in this environment."
        " Rows labeled RANDOM backbone measure the PIPELINE"
        " (detection/matching/verification machinery), not semantic feature"
        " quality.  Rows labeled FINE-TUNED run a backbone trained"
        " from random init on the synthetic tree (self-supervised homography"
        " objective + dense raw-token loss) — the in-environment stand-in"
        " for the reference's pretrained-DINOv2 ViT-vs-SIFT comparison.",
        "",
        "## HPatches protocol (MMA / homography accuracy)",
        "",
        "| extractor | weights | pairs | avg matches | MMA@1 | MMA@3 | MMA@5 | "
        "H-acc@1 | H-acc@3 | H-acc@5 |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    lines += _hpatches_rows(results["hpatches"])
    if results.get("hpatches_holdout"):
        lines += [
            "",
            "## HPatches protocol — HELD-OUT tree (never seen in training)",
            "",
            "Same metrics on a second synthetic tree (different seed, "
            "different base content and warps).  Trained rows' gains here "
            "cannot be memorization of the training images.",
            "",
            "| extractor | weights | pairs | avg matches | MMA@1 | MMA@3 | "
            "MMA@5 | H-acc@1 | H-acc@3 | H-acc@5 |",
            "|---|---|---|---|---|---|---|---|---|---|",
        ]
        lines += _hpatches_rows(results["hpatches_holdout"])
    lines += [
        "",
        "## Reconstruction protocol (full pipeline on rendered scene)",
        "",
        "| extractor | weights | reg. images | 3D points | track len | "
        "reproj err | rot err (GT) | ctr err (GT) | inlier ratio | "
        "verified pairs | wall clock |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for name, r in results["reconstruction"].items():
        rec = r.get("reconstruction") or {}
        mat = r["matching"]
        pose = r.get("pose_vs_gt")
        # The number of cameras the similarity alignment used: a 3-camera
        # alignment fits almost trivially, so its pose errors are optimistic.
        n_al = pose.get("aligned_cameras") if pose else None
        cams = f" ({n_al} cams)" if n_al is not None else ""
        rot = f"{pose['pose_rot_err_deg_mean']:.3f}°{cams}" if pose else "—"
        ctr = (f"{100 * pose['pose_center_err_rel_mean']:.2f}%{cams}"
               if pose else "—")
        lines.append(
            f"| {name} | {r.get('weights_label', _weights_label(name))} | "
            f"{rec.get('registered_images', 0)} | "
            f"{rec.get('total_3d_points', 0)} | "
            f"{rec.get('avg_track_length', 0):.2f} | "
            f"{rec.get('avg_reprojection_error', 0):.2f}px | "
            f"{rot} | {ctr} | "
            f"{mat['inlier_ratio']:.3f} | {mat['verified_pairs']} | "
            f"{r['wall_clock_s']:.1f}s |"
        )
    lines.append("")
    return "\n".join(lines)


def _hpatches_rows(rows: dict) -> list[str]:
    out = []
    for name, r in rows.items():
        m, h = r["mma"], r["homography_accuracy"]
        out.append(
            f"| {name} | {r.get('weights_label', _weights_label(name))} | "
            f"{r['pairs']} | "
            f"{r['avg_matches']:.0f} | "
            f"{m['1.0']:.3f} | {m['3.0']:.3f} | {m['5.0']:.3f} | "
            f"{h['1.0']:.3f} | {h['3.0']:.3f} | {h['5.0']:.3f} |"
        )
    return out


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--work-dir", type=Path, default=Path("results/quality_torch"))
    ap.add_argument("--extractors", default="sift,vit,trainable_vit")
    ap.add_argument("--backbone", default="vitb14")
    ap.add_argument("--weights", type=Path, default=None,
                    help="DINOv2 .pth for the backbone of every ViT row "
                         "(default: the random init from a seed)")
    ap.add_argument("--train", action="store_true",
                    help="train the trainable head and re-evaluate")
    ap.add_argument("--train-backbone", action="store_true",
                    help="fine-tune the backbone jointly with the heads")
    ap.add_argument("--backbone-lr-scale", type=float, default=0.5,
                    help="backbone LR = lr * this (from-random default 0.5; "
                         "use ~0.1 when starting from pretrained weights)")
    ap.add_argument("--lambda-token", type=float, default=1.0,
                    help="dense raw-token loss weight for --train-backbone")
    ap.add_argument("--train-tree", choices=["same", "big"], default="same",
                    help="'big' trains on a LARGER dedicated tree (seed 11) "
                         "so both eval trees are unseen by training")
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--steps-per-epoch", type=int, default=25)
    ap.add_argument("--batch-size", type=int, default=2)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--focal", type=float, default=600.0)
    ap.add_argument("--n-illum", type=int, default=4)
    ap.add_argument("--n-view", type=int, default=6)
    ap.add_argument("--n-img", type=int, default=6)
    ap.add_argument("--recon-cams", type=int, default=8)
    ap.add_argument("--max-keypoints", type=int, default=2048)
    ap.add_argument("--max-pairs", type=int, default=None)
    ap.add_argument("--skip-recon", action="store_true")
    ap.add_argument("--fast", action="store_true",
                    help="tiny CPU-sized smoke configuration")
    ap.add_argument("--md-only", action="store_true",
                    help="regenerate QUALITY.md from the existing QUALITY.json")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    return ap


def main(argv=None) -> dict:
    args = build_argparser().parse_args(argv)

    if args.md_only:
        results = json.loads((args.work_dir / "QUALITY.json").read_text())
        (args.work_dir / "QUALITY.md").write_text(to_markdown(results))
        print(to_markdown(results))
        return results

    if args.fast:
        args.height, args.width = 126, 168
        args.n_illum, args.n_view, args.n_img = 1, 1, 3
        args.recon_cams = 4
        args.max_keypoints = 256
        args.backbone = "vits14"
        args.epochs, args.steps_per_epoch, args.batch_size = 1, 4, 1

    label = device_label(args.device)  # raises without CUDA unless --device cpu
    work = args.work_dir
    work.mkdir(parents=True, exist_ok=True)
    hp_dir, scene_dir, cam_params = build_data(work, args)
    ho_dir = build_holdout(work, args)
    weights = str(args.weights) if args.weights else None

    def row_weights(row: str, heads_ckpt=None):
        """What a row's extractor loads: ``--weights`` for vit and hybrid;
        for trainable_vit the heads of ``heads_ckpt`` (None: random), with
        ``--weights`` embedded beside them when given."""
        if row.startswith("trainable_vit") and weights is not None:
            return with_backbone(heads_ckpt, weights, work / f"weights_{row}", args.backbone)
        if heads_ckpt is not None:
            return heads_ckpt
        return weights if row in ("vit", "hybrid") else None

    results: dict = {
        "meta": {
            "device": label,
            "backbone": args.backbone,
            "weights_note": (f"backbone weights {weights}" if weights else
                             "random-init backbone (no pretrained weights in env)"),
            "image_size": [args.height, args.width],
            "max_keypoints": args.max_keypoints,
            # 'big': trained on a dedicated larger tree (seed 11), so both
            # evaluation trees are unseen by training.
            "train_tree": getattr(args, "train_tree", "same"),
        },
        "hpatches": {},
        "hpatches_holdout": {},
        "reconstruction": {},
    }
    # Rows of an earlier (possibly partial) run in the same directory are
    # kept, so that single rows can be measured again.
    prev_path = work / "QUALITY.json"
    if prev_path.exists():
        prev = json.loads(prev_path.read_text())
        results["hpatches"].update(prev.get("hpatches", {}))
        results["hpatches_holdout"].update(prev.get("hpatches_holdout", {}))
        results["reconstruction"].update(prev.get("reconstruction", {}))

    def persist() -> None:
        # After every row: a run that stops keeps the rows it measured.
        (work / "QUALITY.json").write_text(json.dumps(results, indent=2))

    extractors = [e for e in args.extractors.split(",") if e]
    for ex in extractors:
        w = row_weights(ex)
        results["hpatches"][ex] = eval_hpatches(hp_dir, ex, args, weights=w)
        persist()
        results["hpatches_holdout"][ex] = eval_hpatches(ho_dir, ex, args, weights=w)
        persist()
        if not args.skip_recon:
            results["reconstruction"][ex] = run_reconstruction(
                scene_dir, ex, args, cam_params, weights=w
            )
            persist()

    if args.train:
        train_dir = (
            build_train_tree(work, args) if args.train_tree == "big"
            else hp_dir
        )
        trained = train_heads(train_dir, work, args)
        # Fine-tuned runs get their own row (and train_heads its own
        # checkpoint directory), so the heads-only trained row stays.
        if args.train_backbone:
            row = "trainable_vit_finetuned"
            trained_label = (
                "trained heads + FINE-TUNED backbone (from random init)"
            )
            trained_weights = trained  # the checkpoint holds its backbone
        else:
            row = "trainable_vit_trained"
            trained_label = "trained heads, RANDOM backbone"
            trained_weights = row_weights(row, trained)
        results["hpatches"][row] = eval_hpatches(
            hp_dir, "trainable_vit", args, weights=trained_weights
        )
        results["hpatches"][row]["weights_label"] = trained_label
        persist()
        results["hpatches_holdout"][row] = eval_hpatches(
            ho_dir, "trainable_vit", args, weights=trained_weights
        )
        results["hpatches_holdout"][row]["weights_label"] = trained_label
        persist()
        if not args.skip_recon:
            results["reconstruction"][row] = (
                run_reconstruction(scene_dir, "trainable_vit", args,
                                   cam_params, weights=trained_weights, tag=row)
            )
            results["reconstruction"][row]["weights_label"] = trained_label
            persist()
        if args.train_backbone:
            # The same fine-tuned backbone on the frozen extraction path
            # (saliency detection and PCA descriptors); the PCA is fitted
            # again on the fine-tuned features.
            fz_label = "frozen FINE-TUNED backbone (from random init)"
            results["hpatches"]["vit_finetuned"] = eval_hpatches(
                hp_dir, "vit", args, weights=trained
            )
            results["hpatches"]["vit_finetuned"]["weights_label"] = fz_label
            persist()
            results["hpatches_holdout"]["vit_finetuned"] = eval_hpatches(
                ho_dir, "vit", args, weights=trained
            )
            results["hpatches_holdout"]["vit_finetuned"]["weights_label"] = (
                fz_label
            )
            persist()
            if not args.skip_recon:
                results["reconstruction"]["vit_finetuned"] = (
                    run_reconstruction(scene_dir, "vit", args,
                                       cam_params, weights=trained,
                                       tag="vit_finetuned")
                )
                results["reconstruction"]["vit_finetuned"]["weights_label"] = (
                    fz_label
                )
                persist()

    persist()
    (work / "QUALITY.md").write_text(to_markdown(results))
    print(f"\nWrote {work / 'QUALITY.json'} and {work / 'QUALITY.md'}")
    print(to_markdown(results))
    return results


if __name__ == "__main__":
    main()
