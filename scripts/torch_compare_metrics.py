#!/usr/bin/env python
"""Side-by-side extractor comparison with %diff and per-metric winner, over
the PyTorch port's exported metrics.

Counterpart of ``scripts/compare_metrics.py``, with its flags, printed
tables and markdown, over ``vit_colmap_tpu_torch.utils.export
.MetricsExporter``: loads the exported metric JSONs of N extractors on a
(dataset, scene), prints a grouped table (features / matching /
reconstruction) with a %diff column for every extractor after the first
(the baseline), marks the winner of each metric, tallies the winners and
optionally writes the table as markdown.  ``--scene all`` iterates every
scene of the dataset.  It reads JSON and computes nothing on a device.

    python3 scripts/torch_compare_metrics.py --results-dir R --dataset D \
        --scene all --extractors sift vit trainable_vit --output R/compare.md
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# (dotted key, label, higher_is_better) grouped by section.
SECTIONS = [
    ("Features", [
        ("features.total_images", "Images", True),
        ("features.total_keypoints", "Total keypoints", True),
        ("features.avg_keypoints_per_image", "Avg keypoints/image", True),
        ("features.median_keypoints", "Median keypoints", True),
    ]),
    ("Matching", [
        ("matching.matched_pairs", "Matched pairs", True),
        ("matching.match_rate", "Match rate %", True),
        ("matching.verified_pairs", "Verified pairs", True),
        ("matching.verification_rate", "Verification rate %", True),
        ("matching.total_raw_matches", "Raw matches", True),
        ("matching.avg_raw_matches", "Avg raw matches", True),
        ("matching.total_inlier_matches", "Inlier matches", True),
        ("matching.avg_inlier_matches", "Avg inliers", True),
        ("matching.inlier_ratio", "Inlier ratio", True),
    ]),
    ("Reconstruction", [
        ("reconstruction.num_reconstructions", "Reconstructions", True),
        ("reconstruction.registered_images", "Registered images", True),
        ("reconstruction.registration_rate", "Registration rate %", True),
        ("reconstruction.total_3d_points", "3D points", True),
        ("reconstruction.avg_track_length", "Avg track length", True),
        ("reconstruction.avg_reprojection_error", "Reproj error px", False),
    ]),
]


def _get(result, dotted):
    obj = result
    for part in dotted.split("."):
        if obj is None:
            return None
        obj = getattr(obj, part, None)
    return obj


def compare_scene(exp, dataset, scene, extractors, md_lines=None):
    results = {e: exp.load_metrics(dataset, scene, e) for e in extractors}
    present = [e for e in extractors if results[e] is not None]
    missing = [e for e in extractors if results[e] is None]
    if missing:
        print(f"[{dataset}/{scene}] missing metrics for: {missing}")
    if len(present) < 2:
        print(f"[{dataset}/{scene}] need >=2 extractors with results")
        return {}

    base = present[0]
    width = 26 + 16 * len(present) + 10 * (len(present) - 1) + 14
    print(f"\n=== {dataset}/{scene} (baseline: {base}) ===")
    header = f"{'Metric':<26}" + "".join(f"{e:>16}" for e in present)
    header += "".join(f"{'%d ' + e[:6]:>10}" for e in present[1:]) + f"{'winner':>14}"
    wins: dict[str, int] = {e: 0 for e in present}
    if md_lines is not None:
        md_lines.append(f"### {dataset}/{scene}")
        md_lines.append("")
        md_lines.append(
            "| Metric | " + " | ".join(present)
            + " | " + " | ".join(f"%diff {e}" for e in present[1:])
            + " | winner |"
        )
        md_lines.append("|" + "---|" * (2 * len(present) + 1))
    for section, metrics in SECTIONS:
        print(f"\n-- {section} " + "-" * max(0, width - len(section) - 4))
        print(header)
        for key, label, higher_better in metrics:
            vals = [_get(results[e], key) for e in present]
            if all(v is None for v in vals):
                continue
            fvals = [float(v) if v is not None else float("nan") for v in vals]
            base_v = fvals[0]
            pcts = [
                (v - base_v) / abs(base_v) * 100 if base_v else float("nan")
                for v in fvals[1:]
            ]
            pick = max if higher_better else min
            winner = present[fvals.index(pick(fvals))]
            wins[winner] += 1
            row = f"{label:<26}" + "".join(f"{v:>16.4g}" for v in fvals)
            row += "".join(f"{p:>+10.1f}" for p in pcts) + f"{winner:>14}"
            print(row)
            if md_lines is not None:
                md_lines.append(
                    f"| {label} | "
                    + " | ".join(f"{v:.4g}" for v in fvals)
                    + " | " + " | ".join(f"{p:+.1f}%" for p in pcts)
                    + f" | {winner} |"
                )
    print("\nPer-metric wins: "
          + ", ".join(f"{e}: {n}" for e, n in
                      sorted(wins.items(), key=lambda kv: -kv[1])))
    if md_lines is not None:
        md_lines.append("")
        md_lines.append(
            "Per-metric wins: "
            + ", ".join(f"**{e}**: {n}" for e, n in
                        sorted(wins.items(), key=lambda kv: -kv[1]))
        )
        md_lines.append("")
    return wins


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--results-dir", type=Path, default=Path("data/results"))
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--scene", required=True,
                    help="Scene name, or 'all' for every scene in the dataset")
    ap.add_argument(
        "--extractors", nargs="+", default=["colmap_sift", "vit"],
        help="Extractors to compare (first is the baseline)",
    )
    ap.add_argument("--output", type=Path, default=None,
                    help="Also write the comparison as markdown")
    args = ap.parse_args(argv)

    from vit_colmap_tpu_torch.utils.export import MetricsExporter

    exp = MetricsExporter(args.results_dir)
    md_lines = ["# Extractor comparison", ""] if args.output else None

    if args.scene == "all":
        droot = args.results_dir / args.dataset
        scenes = sorted(p.name for p in droot.iterdir() if p.is_dir()) \
            if droot.exists() else []
        if not scenes:
            print(f"No scenes found under {droot}")
            return
        total: dict[str, int] = {}
        for scene in scenes:
            wins = compare_scene(exp, args.dataset, scene, args.extractors,
                                 md_lines)
            for e, n in wins.items():
                total[e] = total.get(e, 0) + n
        if total:
            print("\n=== Overall wins across scenes: "
                  + ", ".join(f"{e}: {n}" for e, n in
                              sorted(total.items(), key=lambda kv: -kv[1])))
    else:
        compare_scene(exp, args.dataset, args.scene, args.extractors, md_lines)

    if args.output and md_lines:
        args.output.parent.mkdir(parents=True, exist_ok=True)
        args.output.write_text("\n".join(md_lines))
        print(f"Wrote {args.output}")


if __name__ == "__main__":
    main()
