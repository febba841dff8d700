"""Metrics plotting: SIFT-vs-ViT comparison panels.

The port's copy of ``vit_colmap_tpu/utils/plot_metrics.py``, over its own
``utils/export.py`` and ``utils/metrics.py`` (the exported JSON is the JAX
package's format): ratio bar panels normalized to SIFT = 1.0 with
raw-value annotations, a 3-panel single-scan figure (features / matching /
reconstruction), and a multi-scan summary (3D points, inlier ratio,
registered cameras).  matplotlib is imported when a figure is drawn, not
with the module; where it is missing a plot raises ``ImportError`` saying
so.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from vit_colmap_tpu_torch.utils.export import MetricsExporter
from vit_colmap_tpu_torch.utils.metrics import MetricsResult

logger = logging.getLogger(__name__)

_RATIO_METRICS = [
    ("features.avg_keypoints_per_image", "Avg keypoints"),
    ("matching.avg_raw_matches", "Avg raw matches"),
    ("matching.avg_inlier_matches", "Avg inliers"),
    ("matching.inlier_ratio", "Inlier ratio"),
    ("reconstruction.total_3d_points", "3D points"),
    ("reconstruction.registered_images", "Registered images"),
]


def pyplot():
    """matplotlib's pyplot on the Agg backend; ``ImportError`` with the
    reason where matplotlib is not installed."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            "plotting needs matplotlib, which is not installed; the metrics "
            "themselves are in the exported JSON and summary.csv") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _get(result: MetricsResult, dotted: str) -> float:
    obj = result
    for part in dotted.split("."):
        if obj is None:
            return 0.0
        obj = getattr(obj, part, None)
    return float(obj or 0.0)


class MetricsPlotter:
    def __init__(self, results_dir: Path | str, output_dir: Optional[Path | str] = None):
        self.exporter = MetricsExporter(results_dir)
        self.output_dir = Path(output_dir or Path(results_dir) / "plots")
        self.output_dir.mkdir(parents=True, exist_ok=True)

    def plot_comparison(
        self,
        dataset: str,
        scene: str,
        extractors: Sequence[str] = ("colmap_sift", "vit"),
        baseline: str = "colmap_sift",
        save_name: Optional[str] = None,
    ) -> Optional[Path]:
        """Ratio bars normalized to the baseline extractor (= 1.0)."""
        plt = pyplot()

        results = {
            e: self.exporter.load_metrics(dataset, scene, e) for e in extractors
        }
        if results.get(baseline) is None:
            logger.warning("Baseline %s missing for %s/%s", baseline, dataset, scene)
            return None
        present = [e for e, r in results.items() if r is not None]

        fig, axes = plt.subplots(2, 3, figsize=(15, 8))
        for ax, (key, title) in zip(axes.ravel(), _RATIO_METRICS):
            base_val = _get(results[baseline], key)
            xs, ratios, raws = [], [], []
            for e in present:
                v = _get(results[e], key)
                xs.append(e)
                ratios.append(v / base_val if base_val else 0.0)
                raws.append(v)
            bars = ax.bar(xs, ratios, color=["#888"] + ["#2a7"] * (len(xs) - 1))
            ax.axhline(1.0, color="k", lw=0.8, ls="--")
            for b, raw in zip(bars, raws):
                ax.annotate(
                    f"{raw:.3g}",
                    (b.get_x() + b.get_width() / 2, b.get_height()),
                    ha="center", va="bottom", fontsize=8,
                )
            ax.set_title(title)
            ax.set_ylabel(f"ratio vs {baseline}")
        fig.suptitle(f"{dataset}/{scene}")
        fig.tight_layout()
        out = self.output_dir / (save_name or f"{dataset}_{scene}_comparison.png")
        fig.savefig(out, dpi=120)
        plt.close(fig)
        logger.info("Saved %s", out)
        return out

    def plot_single_scan(
        self, dataset: str, scene: str, extractor: str, save_name: Optional[str] = None
    ) -> Optional[Path]:
        """3-panel figure for one run: features / matching / reconstruction."""
        plt = pyplot()

        r = self.exporter.load_metrics(dataset, scene, extractor)
        if r is None:
            return None
        fig, axes = plt.subplots(1, 3, figsize=(15, 4))
        f = r.features
        axes[0].bar(
            ["total", "avg", "min", "max", "median"],
            [f.total_keypoints, f.avg_keypoints_per_image, f.min_keypoints,
             f.max_keypoints, f.median_keypoints],
        )
        axes[0].set_title("Features (keypoints)")
        m = r.matching
        axes[1].bar(
            ["pairs", "matched", "verified", "raw/100", "inl/100"],
            [m.total_image_pairs, m.matched_pairs, m.verified_pairs,
             m.total_raw_matches / 100, m.total_inlier_matches / 100],
        )
        axes[1].set_title(f"Matching (inlier ratio {m.inlier_ratio:.2f})")
        if r.reconstruction:
            rc = r.reconstruction
            axes[2].bar(
                ["models", "reg imgs", "pts/100", "track len", "err px"],
                [rc.num_reconstructions, rc.registered_images,
                 rc.total_3d_points / 100, rc.avg_track_length,
                 rc.avg_reprojection_error],
            )
            axes[2].set_title("Reconstruction")
        else:
            axes[2].text(0.5, 0.5, "no reconstruction", ha="center")
        fig.suptitle(f"{dataset}/{scene}/{extractor}")
        fig.tight_layout()
        out = self.output_dir / (save_name or f"{dataset}_{scene}_{extractor}.png")
        fig.savefig(out, dpi=120)
        plt.close(fig)
        return out

    def plot_summary(self, save_name: str = "summary.png") -> Optional[Path]:
        """Multi-scan summary: 3D points / inlier ratio / registered images
        per (dataset, scene), grouped by extractor."""
        plt = pyplot()

        results = self.exporter.load_all_metrics()
        if not results:
            return None
        scans = sorted({(r.dataset, r.scene) for r in results})
        extractors = sorted({r.extractor_type for r in results})
        fig, axes = plt.subplots(3, 1, figsize=(max(8, 2 * len(scans)), 10))
        metrics = [
            ("reconstruction.total_3d_points", "3D points"),
            ("matching.inlier_ratio", "Inlier ratio"),
            ("reconstruction.registered_images", "Registered images"),
        ]
        width = 0.8 / max(len(extractors), 1)
        x = np.arange(len(scans))
        for ax, (key, title) in zip(axes, metrics):
            for k, e in enumerate(extractors):
                vals = []
                for ds, sc in scans:
                    r = next(
                        (q for q in results
                         if (q.dataset, q.scene, q.extractor_type) == (ds, sc, e)),
                        None,
                    )
                    vals.append(_get(r, key) if r else 0.0)
                ax.bar(x + k * width, vals, width, label=e)
            ax.set_xticks(x + width * (len(extractors) - 1) / 2)
            ax.set_xticklabels([f"{d}/{s}" for d, s in scans], rotation=30, ha="right")
            ax.set_title(title)
            ax.legend(fontsize=8)
        fig.tight_layout()
        out = self.output_dir / save_name
        fig.savefig(out, dpi=120)
        plt.close(fig)
        return out
