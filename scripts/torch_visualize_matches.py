#!/usr/bin/env python
"""Visualize matched keypoints between two images with inlier/outlier
distinction, from a database the PyTorch port wrote.

Counterpart of ``scripts/visualize_matches.py``, with its flags, over
``vit_colmap_tpu_torch.database.ColmapDatabase``: image lookup by name or
0-based index, inlier (green) and outlier (red) match lines read from
``two_view_geometries``, ``--filter all|inliers|outliers``, all-keypoint
overlays with top-K score labels, orientation arrows, colours, sizes and
line widths, match subsampling with a seed, the ``--list-images`` /
``--list-matches`` database explorers, ``--all-pairs`` and save-to-file or
interactive display.  Images are read with ``utils/image_io.imread_rgb``
(PNG, PPM, JPEG).  The explorers need no matplotlib; drawing imports it
only when a figure is drawn and raises ``ImportError`` where it is missing
(the card's machine has none: draw elsewhere from the database and the
images).  It computes nothing on a device.

    python3 scripts/torch_visualize_matches.py --database db.db --list-matches
    python3 scripts/torch_visualize_matches.py --database db.db --image-dir images \\
        --image1 0 --image2 1 --output pair.png
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Visualize matches with inlier/outlier distinction"
    )
    p.add_argument("--database", "--db", dest="database", type=Path,
                   required=True, help="Path to COLMAP database")
    p.add_argument("--image-dir", "--images", dest="image_dir", type=Path,
                   default=None, help="Directory containing images")
    p.add_argument("--image1", type=str, default=None,
                   help="First image name or 0-based index")
    p.add_argument("--image2", type=str, default=None,
                   help="Second image name or 0-based index")
    p.add_argument("--output", type=Path, default=None,
                   help="Save path (default: display interactively)")
    p.add_argument("--all-pairs", action="store_true",
                   help="Render every matched pair into --output-dir")
    p.add_argument("--output-dir", type=Path, default=Path("match_viz"))
    p.add_argument("--max-matches", type=int, default=None,
                   help="Max match lines to draw (random sample)")
    p.add_argument("--filter", choices=["all", "inliers", "outliers"],
                   default="all")
    p.add_argument("--show-all-keypoints", action="store_true",
                   help="Draw all keypoints, not just matched ones")
    p.add_argument("--show-scores", action="store_true",
                   help="Label keypoint scores (6-col keypoints only)")
    p.add_argument("--max-score-labels", type=int, default=100)
    p.add_argument("--show-orientation", action="store_true")
    p.add_argument("--orientation-scale", type=float, default=10.0)
    p.add_argument("--inlier-color", default="green")
    p.add_argument("--outlier-color", default="red")
    p.add_argument("--keypoint-color", default="deepskyblue")
    p.add_argument("--keypoint-size", type=float, default=3.0)
    p.add_argument("--line-width", type=float, default=0.5)
    p.add_argument("--dpi", type=int, default=150)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--list-images", action="store_true",
                   help="List database images and exit")
    p.add_argument("--list-matches", action="store_true",
                   help="List matched pairs with statistics and exit")
    return p.parse_args(argv)


def get_image_by_name_or_index(images: dict[int, dict], key: str) -> int:
    """Resolve an image spec (exact name, or 0-based index into the sorted
    image list) to an image_id — reference ``visualize_matches.py:165-236``."""
    by_name = {info["name"]: iid for iid, info in images.items()}
    if key in by_name:
        return by_name[key]
    try:
        idx = int(key)
    except ValueError:
        raise SystemExit(
            f"Image {key!r} not found. Available: {sorted(by_name)[:20]}"
        )
    ordered = sorted(images.keys(), key=lambda i: images[i]["name"])
    if not 0 <= idx < len(ordered):
        raise SystemExit(f"Index {idx} out of range (0..{len(ordered) - 1})")
    return ordered[idx]


def list_images_in_database(db) -> None:
    images = db.read_images()
    print(f"{'idx':>4} {'image_id':>9} {'name':<40} {'keypoints':>10}")
    for idx, iid in enumerate(sorted(images, key=lambda i: images[i]["name"])):
        k = db.read_keypoints(iid)
        print(f"{idx:>4} {iid:>9} {images[iid]['name']:<40} "
              f"{0 if k is None else len(k):>10}")


def list_matches_in_database(db) -> None:
    images = db.read_images()
    rows = []
    for (i, j), m in sorted(db.read_all_matches().items()):
        g = db.read_two_view_geometry(i, j)
        n_inl = len(g["inlier_matches"]) if g else 0
        cfg = g["config"] if g else "-"
        rows.append((images[i]["name"], images[j]["name"], len(m), n_inl, cfg))
    print(f"{'image 1':<28}{'image 2':<28}{'raw':>7}{'inliers':>9}"
          f"{'ratio':>8}{'config':>8}")
    for n1, n2, raw, inl, cfg in rows:
        ratio = inl / raw if raw else 0.0
        print(f"{n1:<28}{n2:<28}{raw:>7}{inl:>9}{ratio:>8.2f}{cfg!s:>8}")
    if rows:
        raws = [r[2] for r in rows]
        inls = [r[3] for r in rows]
        print(f"\n{len(rows)} matched pairs | raw matches "
              f"min/med/max {min(raws)}/{int(np.median(raws))}/{max(raws)} | "
              f"total inliers {sum(inls)}")


def classify_matches(matches: np.ndarray, geometry) -> np.ndarray:
    """Boolean inlier flag per raw match row."""
    if geometry is None or len(geometry.get("inlier_matches", ())) == 0:
        return np.zeros(len(matches), bool)
    inlier_set = {tuple(r) for r in np.asarray(geometry["inlier_matches"])}
    return np.array([tuple(r) in inlier_set for r in matches], bool)


def draw_keypoint_overlays(ax, kpts, x_off, args):
    """All-keypoint markers + optional score labels + orientation arrows."""
    if kpts is None or len(kpts) == 0:
        return
    ax.scatter(kpts[:, 0] + x_off, kpts[:, 1], s=args.keypoint_size,
               c=args.keypoint_color, marker="o", linewidths=0, alpha=0.7)
    has_cols = kpts.shape[1] >= 6
    if args.show_orientation and kpts.shape[1] >= 4:
        ang = kpts[:, 3]
        ax.quiver(
            kpts[:, 0] + x_off, kpts[:, 1],
            np.cos(ang) * args.orientation_scale,
            np.sin(ang) * args.orientation_scale,
            color=args.keypoint_color, angles="xy", scale_units="xy",
            scale=1, width=0.002, alpha=0.8,
        )
    if args.show_scores and has_cols:
        scores = kpts[:, 4]
        top = np.argsort(-scores)[: args.max_score_labels]
        for i in top:
            ax.annotate(f"{scores[i]:.2f}",
                        (kpts[i, 0] + x_off, kpts[i, 1]),
                        fontsize=4, color="yellow")


def _pyplot(interactive: bool):
    """matplotlib's pyplot (Agg unless the figure is shown); ``ImportError``
    with the reason where matplotlib is not installed."""
    if not interactive:
        from vit_colmap_tpu_torch.utils.plot_metrics import pyplot

        return pyplot()
    try:
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise ImportError("drawing matches needs matplotlib, which is not installed; "
                          "--list-images and --list-matches do not") from e
    return plt


def visualize_pair(db, image_dir: Path, id1: int, id2: int, args,
                   out_path: Path | None):
    from vit_colmap_tpu_torch.utils.image_io import imread_rgb

    plt = _pyplot(interactive=out_path is None)
    images = db.read_images()
    name1, name2 = images[id1]["name"], images[id2]["name"]
    try:
        img1 = imread_rgb(image_dir / name1)
        img2 = imread_rgb(image_dir / name2)
    except (OSError, ValueError, NotImplementedError) as e:
        raise SystemExit(f"Could not read {name1} / {name2} in {image_dir}: {e}")

    k1 = db.read_keypoints(id1)
    k2 = db.read_keypoints(id2)
    swap = id1 > id2
    lo, hi = (id2, id1) if swap else (id1, id2)
    matches = db.read_matches(lo, hi)
    if matches is None or len(matches) == 0:
        raise SystemExit(f"No matches between {name1} and {name2}")
    matches = np.asarray(matches)
    if swap:
        matches = matches[:, ::-1]
    geometry = db.read_two_view_geometry(lo, hi)
    inlier_flags = classify_matches(matches[:, ::-1] if swap else matches,
                                    geometry)

    if args.filter == "inliers":
        matches, inlier_flags = matches[inlier_flags], inlier_flags[inlier_flags]
    elif args.filter == "outliers":
        matches, inlier_flags = matches[~inlier_flags], inlier_flags[~inlier_flags]
    n_total = len(matches)
    if args.max_matches is not None and n_total > args.max_matches:
        rng = np.random.default_rng(args.seed)
        sel = rng.choice(n_total, args.max_matches, replace=False)
        matches, inlier_flags = matches[sel], inlier_flags[sel]

    h = max(img1.shape[0], img2.shape[0])
    canvas = np.zeros((h, img1.shape[1] + img2.shape[1], 3), np.uint8)
    canvas[: img1.shape[0], : img1.shape[1]] = img1
    canvas[: img2.shape[0], img1.shape[1]:] = img2
    off = img1.shape[1]

    fig, ax = plt.subplots(figsize=(16, 8))
    ax.imshow(canvas)
    ax.set_axis_off()

    if args.show_all_keypoints:
        draw_keypoint_overlays(ax, k1, 0, args)
        draw_keypoint_overlays(ax, k2, off, args)

    n_in = int(inlier_flags.sum())
    for (a, b), is_in in zip(matches, inlier_flags):
        color = args.inlier_color if is_in else args.outlier_color
        ax.plot([k1[a, 0], k2[b, 0] + off], [k1[a, 1], k2[b, 1]],
                color=color, linewidth=args.line_width, alpha=0.8)
        ax.scatter([k1[a, 0], k2[b, 0] + off], [k1[a, 1], k2[b, 1]],
                   s=args.keypoint_size * 2, c=color, linewidths=0)

    inl_total = len(geometry["inlier_matches"]) if geometry else 0
    cfg = geometry["config"] if geometry else "-"
    ax.set_title(
        f"{name1}  vs  {name2}   |   raw {n_total}   inliers {inl_total} "
        f"({100 * inl_total / max(n_total, 1):.0f}%)   config {cfg}   "
        f"[drawn {len(matches)}: {n_in} {args.inlier_color} / "
        f"{len(matches) - n_in} {args.outlier_color}]"
    )
    fig.tight_layout()
    if out_path is not None:
        out_path.parent.mkdir(parents=True, exist_ok=True)
        fig.savefig(out_path, dpi=args.dpi, bbox_inches="tight")
        plt.close(fig)
        print(f"Wrote {out_path}")
    else:
        plt.show()


def main(argv=None) -> None:
    args = parse_args(argv)
    from vit_colmap_tpu_torch.database import ColmapDatabase

    db = ColmapDatabase(args.database)
    try:
        if args.list_images:
            list_images_in_database(db)
            return
        if args.list_matches:
            list_matches_in_database(db)
            return
        if args.image_dir is None:
            print("--image-dir required to draw matches; showing --list-matches")
            list_matches_in_database(db)
            return
        if args.all_pairs:
            images = db.read_images()
            for (i, j) in sorted(db.read_all_matches().keys()):
                out = args.output_dir / (
                    f"{Path(images[i]['name']).stem}__"
                    f"{Path(images[j]['name']).stem}.png"
                )
                visualize_pair(db, args.image_dir, i, j, args, out)
            return
        if args.image1 is None or args.image2 is None:
            print("Provide --image1/--image2 (or --all-pairs / --list-matches)")
            return
        images = db.read_images()
        id1 = get_image_by_name_or_index(images, args.image1)
        id2 = get_image_by_name_or_index(images, args.image2)
        visualize_pair(db, args.image_dir, id1, id2, args, args.output)
    finally:
        db.close()


if __name__ == "__main__":
    main()
