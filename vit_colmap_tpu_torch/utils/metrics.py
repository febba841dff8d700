"""Metrics extraction from COLMAP databases.

The port's copy of ``vit_colmap_tpu/utils/metrics.py``: the same metric
definitions and dataclass tree (FeatureMetrics / MatchingMetrics /
ReconstructionMetrics / MetricsResult) and the same raw-SQL reads of the
keypoints / matches / two_view_geometries tables.  Reconstruction metrics
read duck-typed reconstructions (``.images``, ``.points3D`` with
``.track`` and ``.error``); the port has no mapper yet, so its pipeline
passes none.
"""

from __future__ import annotations

import logging
import sqlite3
from dataclasses import asdict, dataclass, field
from datetime import datetime
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

logger = logging.getLogger(__name__)


@dataclass
class FeatureMetrics:
    total_images: int
    total_keypoints: int
    avg_keypoints_per_image: float
    min_keypoints: int
    max_keypoints: int
    median_keypoints: float


@dataclass
class MatchingMetrics:
    total_image_pairs: int
    matched_pairs: int
    verified_pairs: int
    match_rate: float  # percentage of possible pairs with matches

    total_raw_matches: int
    avg_raw_matches: float
    min_raw_matches: int
    max_raw_matches: int
    median_raw_matches: float

    total_inlier_matches: int
    avg_inlier_matches: float
    min_inlier_matches: int
    max_inlier_matches: int
    median_inlier_matches: float
    inlier_ratio: float

    verification_rate: float = 0.0
    pairs_above_threshold: int = 0
    config_distribution: Dict[str, int] = field(default_factory=dict)


@dataclass
class ReconstructionMetrics:
    num_reconstructions: int
    registered_images: int
    registration_rate: float
    total_3d_points: int
    avg_track_length: float
    avg_reprojection_error: float
    reconstructions: list[Dict[str, Any]] = field(default_factory=list)


@dataclass
class MetricsResult:
    dataset: str
    scene: str
    extractor_type: str
    timestamp: str
    features: FeatureMetrics
    matching: MatchingMetrics
    reconstruction: Optional[ReconstructionMetrics] = None
    config: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "MetricsResult":
        data = dict(data)
        if data.get("features"):
            data["features"] = FeatureMetrics(**data["features"])
        if data.get("matching"):
            data["matching"] = MatchingMetrics(**data["matching"])
        if data.get("reconstruction"):
            data["reconstruction"] = ReconstructionMetrics(**data["reconstruction"])
        return cls(**data)


class MetricsExtractor:
    """Extracts metrics from a COLMAP database + reconstruction outputs."""

    CONFIG_NAMES = {
        0: "UNDEFINED",
        1: "DEGENERATE",
        2: "CALIBRATED",
        3: "UNCALIBRATED",
        4: "PLANAR",
        5: "PANORAMIC",
        6: "PLANAR_OR_PANORAMIC",
        7: "WATERMARK",
        8: "MULTIPLE",
        9: "CALIBRATED_RIG",
    }

    def __init__(self, db_path: Path | str, output_dir: Path | str):
        self.db_path = Path(db_path)
        self.output_dir = Path(output_dir)

    def extract_feature_metrics(self) -> FeatureMetrics:
        conn = sqlite3.connect(str(self.db_path))
        num_images = conn.execute("SELECT COUNT(*) FROM images").fetchone()[0]
        counts = [r[0] for r in conn.execute("SELECT rows FROM keypoints")]
        conn.close()
        total = int(sum(counts))
        return FeatureMetrics(
            total_images=num_images,
            total_keypoints=total,
            avg_keypoints_per_image=total / len(counts) if counts else 0,
            min_keypoints=min(counts) if counts else 0,
            max_keypoints=max(counts) if counts else 0,
            median_keypoints=float(np.median(counts)) if counts else 0.0,
        )

    def extract_matching_metrics(
        self, min_threshold: Optional[int] = None
    ) -> MatchingMetrics:
        conn = sqlite3.connect(str(self.db_path))
        num_images = conn.execute("SELECT COUNT(*) FROM images").fetchone()[0]
        total_possible = num_images * (num_images - 1) // 2

        raw_counts = [r[0] for r in conn.execute("SELECT rows FROM matches")]
        tvg = conn.execute("SELECT rows, config FROM two_view_geometries").fetchall()
        conn.close()

        inlier_counts = [r[0] for r in tvg]
        config_distribution: Dict[str, int] = {}
        for _, cfg in tvg:
            name = self.CONFIG_NAMES.get(cfg, f"UNKNOWN({cfg})")
            config_distribution[name] = config_distribution.get(name, 0) + 1

        total_raw = int(sum(raw_counts))
        total_inl = int(sum(inlier_counts))
        pairs_above = (
            sum(1 for c in inlier_counts if c >= min_threshold)
            if min_threshold is not None
            else 0
        )
        return MatchingMetrics(
            total_image_pairs=total_possible,
            matched_pairs=len(raw_counts),
            verified_pairs=len(tvg),
            match_rate=len(raw_counts) / total_possible * 100 if total_possible else 0,
            total_raw_matches=total_raw,
            avg_raw_matches=float(np.mean(raw_counts)) if raw_counts else 0,
            min_raw_matches=min(raw_counts) if raw_counts else 0,
            max_raw_matches=max(raw_counts) if raw_counts else 0,
            median_raw_matches=float(np.median(raw_counts)) if raw_counts else 0,
            total_inlier_matches=total_inl,
            avg_inlier_matches=float(np.mean(inlier_counts)) if inlier_counts else 0,
            min_inlier_matches=min(inlier_counts) if inlier_counts else 0,
            max_inlier_matches=max(inlier_counts) if inlier_counts else 0,
            median_inlier_matches=float(np.median(inlier_counts))
            if inlier_counts
            else 0,
            inlier_ratio=total_inl / total_raw if total_raw else 0,
            verification_rate=len(tvg) / len(raw_counts) * 100 if raw_counts else 0,
            pairs_above_threshold=pairs_above,
            config_distribution=config_distribution,
        )

    def extract_reconstruction_metrics(
        self, reconstructions: Optional[Dict[int, Any]]
    ) -> Optional[ReconstructionMetrics]:
        """``reconstructions`` maps index -> sfm.Reconstruction (duck-typed:
        needs .images dict, .points3D dict of points with .track and .error)."""
        if not reconstructions:
            return None
        conn = sqlite3.connect(str(self.db_path))
        total_images = conn.execute("SELECT COUNT(*) FROM images").fetchone()[0]
        conn.close()

        total_registered = 0
        total_points = 0
        all_track_lengths: list[int] = []
        all_errors: list[float] = []
        details = []
        for idx, recon in reconstructions.items():
            n_reg = len(recon.images)
            n_pts = len(recon.points3D)
            total_registered += n_reg
            total_points += n_pts
            tls = [len(p.track) for p in recon.points3D.values()]
            errs = [float(p.error) for p in recon.points3D.values()]
            all_track_lengths.extend(tls)
            all_errors.extend(errs)
            details.append(
                {
                    "id": idx,
                    "registered_images": n_reg,
                    "num_3d_points": n_pts,
                    "avg_track_length": float(np.mean(tls)) if tls else 0,
                    "avg_reprojection_error": float(np.mean(errs)) if errs else 0,
                }
            )
        return ReconstructionMetrics(
            num_reconstructions=len(reconstructions),
            registered_images=total_registered,
            registration_rate=total_registered / total_images * 100
            if total_images
            else 0,
            total_3d_points=total_points,
            avg_track_length=float(np.mean(all_track_lengths))
            if all_track_lengths
            else 0,
            avg_reprojection_error=float(np.mean(all_errors)) if all_errors else 0,
            reconstructions=details,
        )

    def extract_all_metrics(
        self,
        dataset: str,
        scene: str,
        extractor_type: str,
        config: Optional[Dict[str, Any]] = None,
        reconstructions: Optional[Dict[int, Any]] = None,
    ) -> MetricsResult:
        logger.info("Extracting metrics...")
        features = self.extract_feature_metrics()
        matching = self.extract_matching_metrics()
        reconstruction = self.extract_reconstruction_metrics(reconstructions)
        return MetricsResult(
            dataset=dataset,
            scene=scene,
            extractor_type=extractor_type,
            timestamp=datetime.now().isoformat(),
            features=features,
            matching=matching,
            reconstruction=reconstruction,
            config=config or {},
        )
