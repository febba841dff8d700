#!/usr/bin/env python
"""Visualize homography warping of ViT patch tokens (PCA-RGB panels), on the
PyTorch/CUDA port.

Counterpart of ``scripts/visualize_hpatches_warping.py``, with its flags and
printed line: warps image-1 patch tokens into image 2's frame
(``dataloader/homography_utils.warp_patch_tokens``), maps the warped
cosine similarity (``feature_similarity_map``), projects the tokens to
PCA-RGB and draws the alignment side by side.  :func:`compute` returns the
figure's arrays as numpy and needs no matplotlib; :func:`draw` needs it.
The backbone and image reading are ``torch_visualize_invariant_points``'s.

    python3 scripts/torch_visualize_hpatches_warping.py --image1 a.png \\
        --image2 b.png --homography H.txt --output warp.png    # the card
    python3 scripts/torch_visualize_hpatches_warping.py --image1 a.png --device cpu

Without CUDA and without ``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def pca_rgb(fmap: np.ndarray) -> np.ndarray:
    """(gh, gw, C) -> (gh, gw, 3) PCA-colored in [0, 1]."""
    gh, gw, c = fmap.shape
    x = fmap.reshape(-1, c)
    x = x - x.mean(0)
    _, _, vt = np.linalg.svd(x, full_matrices=False)
    proj = x @ vt[:3].T
    lo, hi = proj.min(0), proj.max(0)
    return ((proj - lo) / np.maximum(hi - lo, 1e-8)).reshape(gh, gw, 3)


def compute(img1, img2, H, feats) -> dict:
    """The figure's arrays: the tokens (``f1``, ``f2``), image 1's warped
    into image 2 (``warped``, ``valid``), the similarity map (``sim``), the
    three PCA-RGB panels and their blend, and the mean in-overlap
    similarity."""
    import torch

    from vit_colmap_tpu_torch.dataloader.homography_utils import (
        feature_similarity_map,
        warp_patch_tokens,
    )

    f1, f2 = feats(img1), feats(img2)
    Ht = torch.as_tensor(np.asarray(H), dtype=torch.float32, device=f1.device)[None]
    warped, valid = warp_patch_tokens(f1, Ht)
    sim, _ = feature_similarity_map(f1, f2, Ht)
    out = {"f1": f1[0], "f2": f2[0], "warped": warped[0], "valid": valid[0], "sim": sim[0]}
    out = {k: v.cpu().numpy() for k, v in out.items()}
    out["rgb1"], out["rgbw"], out["rgb2"] = (pca_rgb(out[k]) for k in ("f1", "warped", "f2"))
    out["blend"] = np.clip(0.5 * out["rgbw"] + 0.5 * out["rgb2"], 0, 1)
    out["mean_similarity"] = float(out["sim"][out["valid"]].mean())
    return out


def draw(res: dict, img1, img2, output: Path) -> None:
    from vit_colmap_tpu_torch.utils.plot_metrics import pyplot

    plt = pyplot()
    fig, axes = plt.subplots(2, 4, figsize=(19, 8))
    axes[0, 0].imshow(img1)
    axes[0, 0].set_title("image 1")
    axes[0, 1].imshow(img2)
    axes[0, 1].set_title("image 2")
    sim_np, valid_np = res["sim"], res["valid"]
    im = axes[0, 2].imshow(np.where(valid_np, sim_np, np.nan),
                           cmap="RdYlGn", vmin=-1, vmax=1)
    fig.colorbar(im, ax=axes[0, 2], fraction=0.046)
    axes[0, 2].set_title("warped cosine similarity (overlap)")
    axes[0, 3].hist(sim_np[valid_np].ravel(), bins=40, color="seagreen")
    axes[0, 3].set_title("similarity histogram")
    axes[0, 3].axis("on")
    axes[1, 0].imshow(res["rgb1"])
    axes[1, 0].set_title("feats 1 (PCA)")
    axes[1, 1].imshow(res["rgbw"])
    axes[1, 1].set_title("feats 1 warped->2")
    axes[1, 2].imshow(res["rgb2"])
    axes[1, 2].set_title("feats 2 (PCA)")
    axes[1, 3].imshow(res["blend"])
    axes[1, 3].set_title("warped/target blend (misalignment ghosting)")
    for k, ax in enumerate(axes.ravel()):
        if k != 3:
            ax.axis("off")
    fig.tight_layout()
    output.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(output, dpi=120)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--image1", type=Path, required=True)
    ap.add_argument("--image2", type=Path, default=None)
    ap.add_argument("--homography", type=Path, default=None)
    ap.add_argument("--backbone", default="vits14")
    ap.add_argument("--weights", type=Path, default=None)
    ap.add_argument("--output", type=Path, default=Path("warping_viz.png"))
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    from scripts.torch_visualize_invariant_points import (
        feature_fn,
        image_pair,
        read_image_pair,
    )

    img1, img2, H = read_image_pair(args.image1, args.image2, args.homography)
    # As the JAX script: both images resized, H kept in the original pixels.
    img1r, img2r, _ = image_pair(img1, img2, H)
    feats = feature_fn(args.backbone, args.weights, args.device)
    res = compute(img1r, img2r, H, feats)
    draw(res, img1r, img2r, args.output)
    print(f"Wrote {args.output}; mean in-overlap similarity {res['mean_similarity']:.3f}")
    return res


if __name__ == "__main__":
    main()
