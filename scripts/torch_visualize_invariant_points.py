#!/usr/bin/env python
"""Visualize invariant-point selection on an image pair, on the PyTorch/CUDA
port.

Counterpart of ``scripts/visualize_invariant_points.py``, with its flags and
printed line: runs the backbone on two homography-related images (an
HPatches sequence pair, two explicit images + H, or a synthetic warp),
selects invariant points with ``dataloader/training_sampler.
select_invariant_points`` (the warped cosine-similarity map) and draws a
side-by-side panel with correspondence lines, similarity-coloured markers
and optional score labels.

:func:`compute` returns the figure's arrays as numpy and needs no
matplotlib; :func:`draw` needs it, and is the only place it is imported.
The backbone is random (seed 0) unless ``--weights`` names a DINOv2 ``.pth``;
``attn_impl`` is "auto", so no hand-written kernel runs.  Images are read
with ``utils/image_io.imread_rgb`` and resized with ``resize_linear``
(OpenCV's ``INTER_LINEAR``, bit for bit).  The helpers :func:`feature_fn`,
:func:`hpatches_pair` and :func:`image_pair` serve the other two token
visualisers as well.

    python3 scripts/torch_visualize_invariant_points.py --image1 a.png \\
        --output inv.png                                      # the card
    python3 scripts/torch_visualize_invariant_points.py --data-root DIR \\
        --sequence v_synth0 --device cpu --output inv.png

Without CUDA and without ``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="Visualize selected invariant points on image pairs"
    )
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--image1", type=Path)
    src.add_argument("--data-root", type=Path, help="HPatches root")
    ap.add_argument("--image2", type=Path, default=None,
                    help="second image (default: synthetic warp of image1)")
    ap.add_argument("--homography", type=Path, default=None,
                    help="3x3 H text file mapping image1 -> image2 pixels")
    ap.add_argument("--sequence", default=None)
    ap.add_argument("--pair-idx", type=int, default=0)
    ap.add_argument("--backbone", default="vits14")
    ap.add_argument("--weights", type=Path, default=None)
    ap.add_argument("--top-k-invariant", "--top-k", dest="top_k", type=int,
                    default=128)
    ap.add_argument("--max-points", type=int, default=None,
                    help="display at most this many (highest similarity)")
    ap.add_argument("--min-similarity", type=float, default=None)
    ap.add_argument("--no-labels", action="store_true")
    ap.add_argument("--show-all-labels", action="store_true")
    ap.add_argument("--point-size", type=float, default=12)
    ap.add_argument("--line-width", type=float, default=0.3)
    ap.add_argument("--font-size", type=int, default=6)
    ap.add_argument("--dpi", type=int, default=150)
    ap.add_argument("--output", type=Path, default=None,
                    help="save path (default: display interactively)")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    return ap.parse_args(argv)


def feature_fn(backbone: str = "vits14", weights=None, device=None, dtype=None):
    """``(H, W, 3) uint8 -> (1, gh, gw, C) float32`` patch tokens of the
    backbone (random from seed 0, or ``weights``, a DINOv2 state dict), on
    ``device``.  ``dtype`` is the backbone's (default bf16, as the JAX
    package's ``make_backbone``)."""
    import torch

    from vit_colmap_tpu_torch.device import resolve_device
    from vit_colmap_tpu_torch.models.dinov2 import make_backbone, preprocess

    device = resolve_device(device)
    kw = {} if dtype is None else {"dtype": dtype}
    model, _ = make_backbone(backbone, generator=torch.Generator().manual_seed(0), **kw)
    if weights:
        from vit_colmap_tpu_torch.models.convert import load_torch_checkpoint

        missing, _ = model.load_state_dict(load_torch_checkpoint(str(weights)), strict=False)
        if missing:
            raise ValueError(f"{weights} lacks backbone keys {missing}")
    model.to(device).eval()

    @torch.no_grad()
    def feats(img: np.ndarray) -> torch.Tensor:
        out = model(preprocess(torch.from_numpy(np.ascontiguousarray(img[None])).to(device)))
        gh, gw = out["grid"]
        return out["x_norm_patchtokens"].reshape(1, gh, gw, -1).float()

    return feats


def hpatches_pair(data_root: Path, sequence=None, pair_idx: int = 0):
    """(image1, image2, H, sequence name) of a reference_only pair of an
    HPatches-layout tree, resized by the dataset (1200 x 1600, patch
    aligned)."""
    from vit_colmap_tpu_torch.dataloader.hpatches_dataset import HPatchesDataset

    ds = HPatchesDataset(data_root, split="all", pair_mode="reference_only")
    idx = 0
    if sequence:
        cands = [i for i, s in enumerate(ds.samples) if Path(s["seq"]).name == sequence]
        if not cands:
            raise SystemExit(f"sequence {sequence!r} not found")
        idx = cands[min(pair_idx, len(cands) - 1)]
    item = ds[idx]
    return item["image1"], item["image2"], item["H"], item["seq_name"]


def image_pair(img1: np.ndarray, img2: np.ndarray, H: np.ndarray):
    """Both images resized to image 1's patch-aligned size (``INTER_LINEAR``)
    and H carried to the resized pixels."""
    from vit_colmap_tpu_torch.dataloader.hpatches_dataset import patch_aligned
    from vit_colmap_tpu_torch.utils.image_io import resize_linear

    th, tw = patch_aligned(img1.shape[0]), patch_aligned(img1.shape[1])
    s = np.diag([tw / img1.shape[1], th / img1.shape[0], 1.0])
    H = s @ H @ np.linalg.inv(s)
    return resize_linear(img1, tw, th), resize_linear(img2, tw, th), H


def read_image_pair(image1: Path, image2=None, homography=None):
    """Image 1 and image 2 (or a synthetic warp of image 1) and H, unresized."""
    from vit_colmap_tpu_torch.utils.image_io import imread_rgb

    img1 = imread_rgb(image1)
    if image2 is not None:
        img2 = imread_rgb(image2)
        H = np.loadtxt(homography).reshape(3, 3) if homography else np.eye(3)
    else:
        from vit_colmap_tpu_torch.dataloader.synthetic_homography import create_synthetic_pair

        img2, H = create_synthetic_pair(img1)
    return img1, img2, H


def load_pair(args):
    if args.data_root is not None:
        return hpatches_pair(args.data_root, args.sequence, args.pair_idx)
    img1, img2, H = read_image_pair(args.image1, args.image2, args.homography)
    return (*image_pair(img1, img2, H), args.image1.stem)


def compute(img1, img2, H, feats, top_k: int = 128, min_similarity=None,
            max_points=None) -> dict:
    """The figure's arrays: every selected cell's grid coordinates in both
    images, similarity and validity (``coords1_grid``, ``coords2_grid``,
    ``similarity``, ``valid``), and the points drawn (``c1``, ``c2`` in
    pixels, ``sim``), filtered and sorted by similarity, highest first."""
    import torch

    from vit_colmap_tpu_torch.dataloader.training_sampler import select_invariant_points

    f1, f2 = feats(img1), feats(img2)
    inv = select_invariant_points(
        f1, f2, torch.as_tensor(np.asarray(H), dtype=torch.float32, device=f1.device)[None],
        top_k=top_k)
    out = {k: getattr(inv, k)[0].cpu().numpy()
           for k in ("coords1_grid", "coords2_grid", "similarity", "valid")}
    valid = out["valid"]
    c1 = (out["coords1_grid"][valid] + 0.5) * 14
    c2 = (out["coords2_grid"][valid] + 0.5) * 14
    sim = out["similarity"][valid]
    if min_similarity is not None:
        keep = sim >= min_similarity
        c1, c2, sim = c1[keep], c2[keep], sim[keep]
    order = np.argsort(-sim)
    if max_points is not None:
        order = order[:max_points]
    out.update(c1=c1[order], c2=c2[order], sim=sim[order])
    return out


def pyplot(interactive: bool):
    """matplotlib's pyplot: Agg unless the figure is shown."""
    if not interactive:
        from vit_colmap_tpu_torch.utils.plot_metrics import pyplot as agg

        return agg()
    import matplotlib.pyplot as plt

    return plt


def draw(res: dict, img1, img2, name: str, args) -> None:
    plt = pyplot(interactive=args.output is None)
    c1, c2, sim = res["c1"], res["c2"], res["sim"]
    tw = img1.shape[1]
    canvas = np.concatenate([img1, img2], axis=1)
    fig, ax = plt.subplots(figsize=(16, 8))
    ax.imshow(canvas)
    ax.set_axis_off()
    for (x1, y1), (x2, y2) in zip(c1, c2):
        ax.plot([x1, x2 + tw], [y1, y2], color="lime",
                linewidth=args.line_width, alpha=0.7)
    sc = ax.scatter(np.concatenate([c1[:, 0], c2[:, 0] + tw]),
                    np.concatenate([c1[:, 1], c2[:, 1]]),
                    c=np.concatenate([sim, sim]), cmap="viridis",
                    s=args.point_size, vmax=1.0)
    fig.colorbar(sc, ax=ax, fraction=0.02, label="cosine similarity")
    if not args.no_labels:
        n_lab = len(sim) if args.show_all_labels else min(len(sim), 40)
        for (x, y), s_ in zip(c2[:n_lab], sim[:n_lab]):
            ax.annotate(f"{s_:.2f}", (x + tw, y), fontsize=args.font_size,
                        color="yellow", xytext=(2, 2),
                        textcoords="offset points")
    ax.set_title(
        f"{name}: {len(sim)} invariant points "
        f"(similarity {sim.min():.2f}..{sim.max():.2f}, "
        f"mean {sim.mean():.2f})"
    )
    fig.tight_layout()
    if args.output is not None:
        args.output.parent.mkdir(parents=True, exist_ok=True)
        fig.savefig(args.output, dpi=args.dpi, bbox_inches="tight")
        print(f"Wrote {args.output} ({len(sim)} points)")
    else:
        plt.show()


def main(argv=None) -> dict:
    args = parse_args(argv)
    img1, img2, H, name = load_pair(args)
    feats = feature_fn(args.backbone, args.weights, args.device)
    res = compute(img1, img2, H, feats, args.top_k, args.min_similarity, args.max_points)
    draw(res, img1, img2, name, args)
    return res


if __name__ == "__main__":
    main()
