#!/usr/bin/env python
"""Visualize the training sampler on an image pair, on the PyTorch/CUDA port.

Counterpart of ``scripts/visualize_training_sampling.py``, with its flags and
printed line: a 2 x 3 figure of the pair with its invariant points
(``dataloader/training_sampler.select_invariant_points``), the
correspondence lines, in-image negatives around a few anchors, the hard
negatives (``hard_negative_coords``) with their similarities, and the
placement of cross-image negatives, for an HPatches pair or a synthetic
warp of any image.  The anchors and the drawn negatives come from numpy's
``default_rng(--seed)`` in the JAX script's order.  :func:`compute` returns
the figure's arrays as numpy and needs no matplotlib; :func:`draw` needs it.
The backbone and image reading are ``torch_visualize_invariant_points``'s.

    python3 scripts/torch_visualize_training_sampling.py --image photo.png  # the card
    python3 scripts/torch_visualize_training_sampling.py --data-root DIR \\
        --sequence v_synth0 --pair-idx 0 --top-k 64 --device cpu

Without CUDA and without ``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--image", type=Path, help="single image; pair is a "
                     "synthetic warp")
    src.add_argument("--data-root", type=Path, help="HPatches root")
    ap.add_argument("--sequence", default=None)
    ap.add_argument("--pair-idx", type=int, default=0)
    ap.add_argument("--backbone", default="vits14")
    ap.add_argument("--weights", type=Path, default=None)
    ap.add_argument("--top-k", type=int, default=32)
    ap.add_argument("--num-anchors", type=int, default=5,
                    help="anchors whose negatives get drawn")
    ap.add_argument("--num-in-image-neg", type=int, default=6)
    ap.add_argument("--num-hard-neg", type=int, default=4)
    ap.add_argument("--synthetic-preset", default="moderate")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--point-size", type=float, default=14)
    ap.add_argument("--line-width", type=float, default=0.5)
    ap.add_argument("--font-size", type=int, default=6)
    ap.add_argument("--dpi", type=int, default=130)
    ap.add_argument("--output", type=Path, default=Path("sampling_viz.png"))
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    return ap.parse_args(argv)


def load_pair(args):
    from scripts.torch_visualize_invariant_points import hpatches_pair, image_pair

    if args.image is None:
        return hpatches_pair(args.data_root, args.sequence, args.pair_idx)[:3]
    from vit_colmap_tpu_torch.dataloader.synthetic_homography import (
        SyntheticHomographyConfig,
        create_synthetic_pair,
    )
    from vit_colmap_tpu_torch.utils.image_io import imread_rgb

    img1 = imread_rgb(args.image)
    cfg = SyntheticHomographyConfig.preset(args.synthetic_preset)
    img2, H = create_synthetic_pair(img1, cfg, np.random.default_rng(args.seed))
    return image_pair(img1, img2, H)


def to_px(c):
    return (np.asarray(c, np.float64) + 0.5) * 14


def compute(img1, img2, H, feats, top_k: int = 32, num_anchors: int = 5,
            num_in_image_neg: int = 6, num_hard_neg: int = 4, seed: int = 0) -> dict:
    """The figure's arrays: the invariant points (every cell's
    ``coords1_grid``, ``coords2_grid``, ``similarity``, ``valid``; the valid
    ones in pixels ``p1``, ``p2`` with ``sims``), the hard negatives
    (``hard_xy``, ``hard_sim`` of every cell; ``hard_px``, ``hard_s`` of the
    valid), the anchors drawn (``sel``), their in-image negatives in pixels
    (``in_image``, one array an anchor) and the cross-image placements
    (``cross_px``)."""
    import torch

    from vit_colmap_tpu_torch.dataloader.training_sampler import (
        hard_negative_coords,
        sample_features_at,
        select_invariant_points,
    )

    f1, f2 = feats(img1), feats(img2)
    Ht = torch.as_tensor(np.asarray(H), dtype=torch.float32, device=f1.device)[None]
    inv = select_invariant_points(f1, f2, Ht, top_k=top_k)

    def norm(x):
        return x / torch.clamp_min(torch.linalg.norm(x, dim=-1, keepdim=True), 1e-8)

    f2n = norm(f2)
    anchor = norm(sample_features_at(f2n, inv.coords2_grid))
    hard_xy, hard_sim = hard_negative_coords(f2n, inv.coords2_grid, anchor,
                                             top_n=num_hard_neg)
    out = {k: getattr(inv, k)[0].cpu().numpy()
           for k in ("coords1_grid", "coords2_grid", "similarity", "valid")}
    out["hard_xy"], out["hard_sim"] = hard_xy[0].cpu().numpy(), hard_sim[0].cpu().numpy()

    rng = np.random.default_rng(seed)
    gh, gw = f2.shape[1], f2.shape[2]
    v = out["valid"]
    p2 = to_px(out["coords2_grid"])[v]
    out.update(p1=to_px(out["coords1_grid"])[v], p2=p2, sims=out["similarity"][v],
               hard_px=to_px(out["hard_xy"])[v], hard_s=out["hard_sim"][v])
    sel = rng.choice(len(p2), min(num_anchors, len(p2)), replace=False)
    in_image = []
    for k in sel:
        negs = np.stack([rng.uniform(0, gw - 1, num_in_image_neg),
                         rng.uniform(0, gh - 1, num_in_image_neg)], axis=1)
        keep = np.linalg.norm(negs - out["coords2_grid"][v][k], axis=1) >= 16.0 / 14.0
        in_image.append(to_px(negs[keep]))
    xn = rng.uniform(0, gw - 1, 200)
    yn = rng.uniform(0, gh - 1, 200)
    out.update(sel=sel, in_image=in_image, cross_px=np.stack([(xn + 0.5) * 14,
                                                              (yn + 0.5) * 14], axis=1))
    return out


def draw(res: dict, img1, img2, args) -> None:
    from vit_colmap_tpu_torch.utils.plot_metrics import pyplot

    plt = pyplot()
    tw = img1.shape[1]
    p1, p2, sims = res["p1"], res["p2"], res["sims"]
    fig, axes = plt.subplots(2, 3, figsize=(20, 10))

    # (0,0)/(0,1): the pair with invariant points + similarity labels.
    for ax, img, pts, title in (
        (axes[0, 0], img1, p1, "image 1 — invariant points (warped back)"),
        (axes[0, 1], img2, p2, "image 2 — invariant points"),
    ):
        ax.imshow(img)
        ax.scatter(pts[:, 0], pts[:, 1], c=sims, cmap="viridis",
                   s=args.point_size, vmin=sims.min(), vmax=1.0)
        for (x, y), s_ in zip(pts, sims):
            ax.annotate(f"{s_:.2f}", (x, y), fontsize=args.font_size,
                        color="yellow", xytext=(2, 2),
                        textcoords="offset points")
        ax.set_title(title)

    # (0,2): side-by-side correspondences.
    axes[0, 2].imshow(np.concatenate([img1, img2], axis=1))
    for (x1, y1), (x2, y2) in zip(p1, p2):
        axes[0, 2].plot([x1, x2 + tw], [y1, y2], color="lime",
                        linewidth=args.line_width, alpha=0.8)
    axes[0, 2].scatter(p1[:, 0], p1[:, 1], c="lime", s=4)
    axes[0, 2].scatter(p2[:, 0] + tw, p2[:, 1], c="lime", s=4)
    axes[0, 2].set_title(f"correspondences ({len(p1)} invariant pairs)")

    # (1,0): in-image negatives around a few anchors (random, >= min_dist).
    axes[1, 0].imshow(img2)
    colors = plt.cm.tab10(np.linspace(0, 1, len(res["sel"])))
    for color, k, npx in zip(colors, res["sel"], res["in_image"]):
        ax_, ay_ = p2[k]
        axes[1, 0].scatter([ax_], [ay_], c=[color], marker="*", s=140,
                           edgecolors="white", linewidths=0.5)
        axes[1, 0].scatter(npx[:, 0], npx[:, 1], c=[color], marker="x", s=30)
    axes[1, 0].set_title("in-image negatives (x) around anchors (*)")

    # (1,1): hard negatives with similarity labels.
    axes[1, 1].imshow(img2)
    for color, k in zip(colors, res["sel"]):
        ax_, ay_ = p2[k]
        axes[1, 1].scatter([ax_], [ay_], c=[color], marker="*", s=140,
                           edgecolors="white", linewidths=0.5)
        for (x, y), s_ in zip(res["hard_px"][k], res["hard_s"][k]):
            axes[1, 1].plot([ax_, x], [ay_, y], color=color,
                            linewidth=args.line_width, alpha=0.7)
            axes[1, 1].scatter([x], [y], c=[color], marker="s", s=26)
            axes[1, 1].annotate(f"{s_:.2f}", (x, y), fontsize=args.font_size,
                                color="red", xytext=(2, 2),
                                textcoords="offset points")
    axes[1, 1].set_title("hard negatives (most similar, geometrically far)")

    # (1,2): cross-image negatives come from the NEXT batch item (roll by 1);
    # with one pair the roll maps to this image — show placement density.
    axes[1, 2].imshow(img2, alpha=0.6)
    axes[1, 2].scatter(res["cross_px"][:, 0], res["cross_px"][:, 1], c="orange", s=6,
                       alpha=0.6)
    axes[1, 2].set_title("cross-image negative placement (uniform cells of "
                         "the rolled batch item)")

    for ax in axes.ravel():
        ax.axis("off")
    fig.tight_layout()
    args.output.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(args.output, dpi=args.dpi, bbox_inches="tight")


def main(argv=None) -> dict:
    args = parse_args(argv)
    from scripts.torch_visualize_invariant_points import feature_fn

    img1, img2, H = load_pair(args)
    feats = feature_fn(args.backbone, args.weights, args.device)
    res = compute(img1, img2, H, feats, args.top_k, args.num_anchors,
                  args.num_in_image_neg, args.num_hard_neg, args.seed)
    draw(res, img1, img2, args)
    print(f"Wrote {args.output}")
    return res


if __name__ == "__main__":
    main()
