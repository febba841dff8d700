"""Metrics export: JSON per run, an appended summary CSV, and loading.

The port's copy of ``vit_colmap_tpu/utils/export.py``, with the same
on-disk layout: ``{base}/{dataset}/{scene}/{extractor}.json`` plus an
appended ``summary.csv``.
"""

from __future__ import annotations

import csv
import json
import logging
from pathlib import Path
from typing import Dict, List, Optional

from vit_colmap_tpu_torch.utils.metrics import MetricsResult

logger = logging.getLogger(__name__)

_CSV_FIELDS = [
    "timestamp",
    "dataset",
    "scene",
    "extractor_type",
    "total_images",
    "total_keypoints",
    "avg_keypoints_per_image",
    "matched_pairs",
    "verified_pairs",
    "total_raw_matches",
    "total_inlier_matches",
    "inlier_ratio",
    "verification_rate",
    "registered_images",
    "total_3d_points",
    "avg_track_length",
    "avg_reprojection_error",
]


class MetricsExporter:
    def __init__(self, base_dir: Path | str):
        self.base_dir = Path(base_dir)
        self.base_dir.mkdir(parents=True, exist_ok=True)

    def _json_path(self, result: MetricsResult) -> Path:
        return (
            self.base_dir
            / result.dataset
            / result.scene
            / f"{result.extractor_type}.json"
        )

    def export_json(self, result: MetricsResult) -> Path:
        path = self._json_path(result)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            json.dump(result.to_dict(), f, indent=2, default=str)
        logger.info("Exported metrics JSON to %s", path)
        return path

    def append_summary_csv(self, result: MetricsResult) -> Path:
        path = self.base_dir / "summary.csv"
        row = {
            "timestamp": result.timestamp,
            "dataset": result.dataset,
            "scene": result.scene,
            "extractor_type": result.extractor_type,
            "total_images": result.features.total_images,
            "total_keypoints": result.features.total_keypoints,
            "avg_keypoints_per_image": round(
                result.features.avg_keypoints_per_image, 2
            ),
            "matched_pairs": result.matching.matched_pairs,
            "verified_pairs": result.matching.verified_pairs,
            "total_raw_matches": result.matching.total_raw_matches,
            "total_inlier_matches": result.matching.total_inlier_matches,
            "inlier_ratio": round(result.matching.inlier_ratio, 4),
            "verification_rate": round(result.matching.verification_rate, 2),
            "registered_images": result.reconstruction.registered_images
            if result.reconstruction
            else 0,
            "total_3d_points": result.reconstruction.total_3d_points
            if result.reconstruction
            else 0,
            "avg_track_length": round(result.reconstruction.avg_track_length, 3)
            if result.reconstruction
            else 0,
            "avg_reprojection_error": round(
                result.reconstruction.avg_reprojection_error, 4
            )
            if result.reconstruction
            else 0,
        }
        new_file = not path.exists()
        with open(path, "a", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=_CSV_FIELDS)
            if new_file:
                writer.writeheader()
            writer.writerow(row)
        return path

    def export(self, result: MetricsResult) -> Path:
        json_path = self.export_json(result)
        self.append_summary_csv(result)
        return json_path

    # ------------------------------------------------------------------ load
    def load_metrics(
        self, dataset: str, scene: str, extractor_type: str
    ) -> Optional[MetricsResult]:
        path = self.base_dir / dataset / scene / f"{extractor_type}.json"
        if not path.exists():
            return None
        with open(path) as f:
            return MetricsResult.from_dict(json.load(f))

    def load_all_metrics(self) -> List[MetricsResult]:
        results = []
        for path in sorted(self.base_dir.glob("*/*/*.json")):
            try:
                with open(path) as f:
                    results.append(MetricsResult.from_dict(json.load(f)))
            except Exception as e:  # pragma: no cover - defensive
                logger.warning("Failed to load %s: %s", path, e)
        return results

    def comparison_table(
        self, dataset: str, scene: str, extractors: List[str]
    ) -> Dict[str, Optional[MetricsResult]]:
        return {e: self.load_metrics(dataset, scene, e) for e in extractors}


def export_metrics(result: MetricsResult, base_dir: Path | str) -> Path:
    """Convenience wrapper used by the pipeline (reference
    ``utils/export.py`` module-level helper)."""
    return MetricsExporter(base_dir).export(result)
