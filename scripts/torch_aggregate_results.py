#!/usr/bin/env python
"""Aggregate the PyTorch port's exported metrics into comparison tables and
a markdown report, without pandas.

Counterpart of ``scripts/aggregate_results.py``, with its flags, headings
and values, over ``vit_colmap_tpu_torch.utils.export.MetricsExporter``:
one row per exported result (the JAX script's DataFrame, as plain records
with the same rounding), per dataset and scene a pivot of
``PIVOT_METRICS`` by extractor (columns in name order, as
``pivot_table`` sorts them), a relative-performance section against the
baseline (``colmap_sift``, else ``sift``), per dataset the mean and sample
standard deviation (ddof 1, NaN for a single scene) of six metrics by
extractor, and per-metric winner counts over all scenes (ties go to the
first extractor of a scene, as ``idxmax`` gives them).  The tables are laid
out by this script, not by pandas' ``to_string``; their cells are written
as pandas writes them (6 decimals, a column's common trailing zeros
dropped).  ``--csv`` writes the rows through the ``csv`` module.  It
reads JSON and computes nothing on a device.

    python3 scripts/torch_aggregate_results.py --results-dir R \\
        [--dataset D] [--baseline colmap_sift] [--output R/report.md] [--csv R/all.csv]
"""

from __future__ import annotations

import argparse
import csv
import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

PIVOT_METRICS = [
    "keypoints_avg", "matched_pairs", "avg_inliers", "inlier_ratio",
    "registered", "registration_rate", "points3d", "track_len", "reproj_err",
]
RELATIVE_METRICS = [
    ("keypoints_avg", "Avg Keypoints/Image", True),
    ("matched_pairs", "Matched Pairs", True),
    ("avg_inliers", "Avg Inliers", True),
    ("inlier_ratio", "Inlier Ratio", True),
    ("registered", "Registered Images", True),
    ("registration_rate", "Registration Rate (%)", True),
    ("points3d", "Total 3D Points", True),
    ("track_len", "Avg Track Length", True),
    ("reproj_err", "Reprojection Error (px)", False),
]
SUMMARY_METRICS = ["keypoints_total", "avg_inliers", "inlier_ratio", "registered",
                   "registration_rate", "points3d"]


def build_rows(results) -> list[dict]:
    """One record per result, with the JAX script's columns and rounding."""
    rows = []
    for r in results:
        rec = r.reconstruction
        rows.append(
            {
                "dataset": r.dataset,
                "scene": r.scene,
                "extractor": r.extractor_type,
                "timestamp": r.timestamp,
                "images": r.features.total_images,
                "keypoints_total": r.features.total_keypoints,
                "keypoints_avg": round(r.features.avg_keypoints_per_image, 1),
                "matched_pairs": r.matching.matched_pairs,
                "match_rate": round(r.matching.match_rate, 2),
                "verified_pairs": r.matching.verified_pairs,
                "raw_matches": r.matching.total_raw_matches,
                "avg_raw_matches": round(r.matching.avg_raw_matches, 1),
                "inlier_matches": r.matching.total_inlier_matches,
                "avg_inliers": round(r.matching.avg_inlier_matches, 1),
                "inlier_ratio": round(r.matching.inlier_ratio, 4),
                "num_recons": rec.num_reconstructions if rec else 0,
                "registered": rec.registered_images if rec else 0,
                "registration_rate": round(rec.registration_rate, 2) if rec else 0.0,
                "points3d": rec.total_3d_points if rec else 0,
                "track_len": round(rec.avg_track_length, 2) if rec else 0.0,
                "reproj_err": round(rec.avg_reprojection_error, 3) if rec else 0.0,
            }
        )
    return rows


def group_by(rows: list[dict], *keys: str) -> list[tuple]:
    """(key values, rows) in sorted key order, rows in their order: what
    ``DataFrame.groupby`` iterates."""
    groups: dict[tuple, list[dict]] = {}
    for r in rows:
        groups.setdefault(tuple(r[k] for k in keys), []).append(r)
    return sorted(groups.items())


def pivot(rows: list[dict]) -> tuple[list[str], list[tuple[str, list]]]:
    """``pivot_table(index="extractor", values=PIVOT_METRICS,
    aggfunc="first")``: columns in name order, extractors in name order, each
    extractor's first row."""
    cols = sorted(PIVOT_METRICS)
    return cols, [(ex, [g[0][c] for c in cols]) for (ex,), g in group_by(rows, "extractor")]


def sample_std(values: list[float]) -> float:
    n = len(values)
    if n < 2:
        return float("nan")
    mean = sum(values) / n
    return math.sqrt(sum((v - mean) ** 2 for v in values) / (n - 1))


def summary(rows: list[dict]) -> tuple[list[tuple[str, str]], list[tuple[str, list]]]:
    """Mean and sample std (ddof 1) of ``SUMMARY_METRICS`` by extractor."""
    cols = [(m, s) for m in SUMMARY_METRICS for s in ("mean", "std")]
    out = []
    for (ex,), g in group_by(rows, "extractor"):
        cells = []
        for m in SUMMARY_METRICS:
            vals = [float(r[m]) for r in g]
            cells += [sum(vals) / len(vals), sample_std(vals)]
        out.append((ex, cells))
    return cols, out


def column_cells(values: list) -> list[str]:
    """A column's cells as pandas prints them: integers as they are; floats
    with 6 decimals, the trailing zeros that every cell of the column has
    dropped (one decimal kept), NaN as "NaN"."""
    if not any(isinstance(v, float) for v in values):
        return [str(v) for v in values]
    cells = ["NaN" if math.isnan(v) else f"{v:.6f}" for v in values]
    num = [c for c in cells if c != "NaN"]
    while num and all(c.endswith("0") and len(c.split(".")[1]) > 1 for c in num):
        num = [c[:-1] for c in num]
        cells = [c if c == "NaN" else c[:-1] for c in cells]
    return cells


def format_table(index_name: str, header: list[list[str]], body: list[tuple[str, list]]) -> str:
    """Right-aligned columns under one or more header lines, the index's
    name on a line of its own, one line per index value; cells as
    :func:`column_cells` writes them."""
    columns = [column_cells([values[i] for _, values in body]) for i in range(len(header[0]))]
    cells = [[col[r] for col in columns] for r in range(len(body))]
    widths = [max(len(h[i]) for h in header + cells) for i in range(len(header[0]))]
    iw = max([len(index_name)] + [len(str(ix)) for ix, _ in body])
    lines = [" " * iw + "".join(f"  {h[i]:>{w}}" for i, w in enumerate(widths))
             for h in header]
    lines.append(index_name)
    lines += [f"{str(ix):<{iw}}" + "".join(f"  {c:>{w}}" for c, w in zip(row, widths))
              for (ix, _), row in zip(body, cells)]
    return "\n".join(lines)


def relative_section(lines, scene_rows: list[dict], baseline: str) -> None:
    """Each extractor's %delta against the baseline."""
    by_ex = {r["extractor"]: r for r in scene_rows}
    if baseline not in by_ex:
        return
    base = by_ex[baseline]
    others = [e for e in by_ex if e != baseline]
    if not others:
        return
    lines.append(f"### Relative performance vs `{baseline}`")
    lines.append("")
    for ex in others:
        row = by_ex[ex]
        lines.append(f"**{ex}**:")
        for key, label, _hi in RELATIVE_METRICS:
            b, v = float(base.get(key, 0) or 0), float(row.get(key, 0) or 0)
            if b == 0:
                continue
            pct = (v / b - 1) * 100
            lines.append(
                f"- {label}: {pct:+.1f}% ({ex}: {v:.2f}, {baseline}: {b:.2f})"
            )
        lines.append("")


def winner_counts(rows: list[dict], metrics=RELATIVE_METRICS) -> dict[str, int]:
    """Per-metric winner tally across (dataset, scene) groups; a tie goes to
    the first extractor of the scene."""
    counts: dict[str, int] = {}
    for _, g in group_by(rows, "dataset", "scene"):
        if len(g) < 2:
            continue
        for key, _label, hi in metrics:
            vals = [float(r[key]) for r in g]
            if all(math.isnan(v) for v in vals) or all(v == 0 for v in vals):
                continue
            best = (max if hi else min)(v for v in vals if not math.isnan(v))
            winner = g[vals.index(best)]["extractor"]
            counts[winner] = counts.get(winner, 0) + 1
    return counts


def generate_report(rows: list[dict], out: Path, baseline: str) -> None:
    lines = ["# Metrics comparison report", ""]
    for (dataset,), dgroup in group_by(rows, "dataset"):
        lines.append(f"## Dataset: {dataset}")
        lines.append("")
        for (scene,), sgroup in group_by(dgroup, "scene"):
            lines.append(f"### Scene: {scene}")
            lines.append("")
            cols, body = pivot(sgroup)
            lines.append("```")
            lines.append(format_table("extractor", [cols], body))
            lines.append("```")
            lines.append("")
            relative_section(lines, sgroup, baseline)
        lines.append("#### Summary statistics across scenes")
        lines.append("")
        cols, body = summary(dgroup)
        lines.append("```")
        lines.append(format_table("extractor", [[m for m, _ in cols], [s for _, s in cols]],
                                  body))
        lines.append("```")
        lines.append("")
    counts = winner_counts(rows)
    if counts:
        lines.append("## Per-metric winner counts (all datasets/scenes)")
        lines.append("")
        for ex, n in sorted(counts.items(), key=lambda kv: -kv[1]):
            lines.append(f"- **{ex}**: {n}")
        lines.append("")
    out.write_text("\n".join(lines))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--results-dir", type=Path, default=Path("data/results"))
    ap.add_argument("--dataset", default=None, help="Filter to one dataset")
    ap.add_argument("--baseline", default="colmap_sift",
                    help="Baseline extractor for relative sections "
                         "(falls back to 'sift' if absent)")
    ap.add_argument("--output", type=Path, default=None,
                    help="Markdown report path "
                         "(default <results>/comparison_report.md)")
    ap.add_argument("--csv", type=Path, default=None,
                    help="Also dump the full table as CSV")
    args = ap.parse_args(argv)

    from vit_colmap_tpu_torch.utils.export import MetricsExporter

    results = MetricsExporter(args.results_dir).load_all_metrics()
    if args.dataset:
        results = [r for r in results if r.dataset == args.dataset]
    if not results:
        print(f"No metrics found under {args.results_dir}")
        return
    rows = build_rows(results)
    extractors = {r["extractor"] for r in rows}
    baseline = args.baseline
    if baseline not in extractors:
        baseline = "sift" if "sift" in extractors else baseline
    cols = [c for c in rows[0] if c != "timestamp"]
    print(format_table("", [cols], [("", [r[c] for c in cols]) for r in rows]))

    out = args.output or args.results_dir / "comparison_report.md"
    generate_report(rows, out, baseline)
    print(f"\nWrote {out}")
    if args.csv:
        with open(args.csv, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=list(rows[0]))
            writer.writeheader()
            writer.writerows(rows)
        print(f"Wrote {args.csv}")


if __name__ == "__main__":
    main()
