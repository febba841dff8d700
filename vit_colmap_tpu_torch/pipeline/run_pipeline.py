"""Pipeline orchestration + CLI.

Counterpart of ``vit_colmap_tpu/pipeline/run_pipeline.py``:
``Pipeline(config).run(image_dir, output_dir, db_path, dataset, scene,
results_dir)`` extracts features into a COLMAP database, matches and
verifies every pair, reconstructs (stage 3, on by default, written to
``<output>/sparse/<idx>/``; ``--skip-reconstruction`` turns it off) and
exports the metrics, with the same flags and the same per-stage report.
The stages report into ``utils/profiling.GLOBAL_TIMER``, whose table is
logged after each run; ``--profile-dir`` (``VIT_COLMAP_PROFILE_DIR``)
writes a ``torch.profiler`` trace of the run.  Extractors: ``vit``,
``trainable_vit``, ``sift`` (and its alias ``colmap_sift``), ``hybrid``
(OpenCV's SIFT detector, ``ops/cv_detectors.py``, with ViT descriptors) and
``dummy``; any other name raises ``ValueError`` before a stage runs.
"""

from __future__ import annotations

import argparse
import logging
import os
import time
from pathlib import Path
from typing import Optional

from vit_colmap_tpu_torch.database import ColmapDatabase
from vit_colmap_tpu_torch.device import resolve_device
from vit_colmap_tpu_torch.utils.config import Config
from vit_colmap_tpu_torch.utils.export import export_metrics
from vit_colmap_tpu_torch.utils.metrics import MetricsExtractor, MetricsResult
from vit_colmap_tpu_torch.utils.profiling import GLOBAL_TIMER, trace

logger = logging.getLogger(__name__)

PORTED_EXTRACTORS = ("vit", "trainable_vit", "sift", "colmap_sift", "dummy", "hybrid")
# Extractors whose descriptors are stored with the signed uint8 encoding.
SIGNED_DESCRIPTORS = ("vit", "trainable_vit", "hybrid")


class Pipeline:
    def __init__(self, config: Optional[Config] = None, device=None):
        self.config = config or Config()
        self.device = resolve_device(device)
        self._extractors: dict[tuple, object] = {}
        self.reconstructions: dict = {}

    def _check_extractor(self) -> None:
        etype = self.config.extractor.extractor_type
        if etype not in PORTED_EXTRACTORS:
            raise ValueError(f"Unknown extractor type: {etype!r} "
                             f"(one of {', '.join(map(repr, PORTED_EXTRACTORS))})")

    def _make_extractor(self):
        ecfg = self.config.extractor
        key = tuple(sorted((k, str(v)) for k, v in vars(ecfg).items()))
        if key in self._extractors:
            return self._extractors[key]
        if ecfg.extractor_type == "dummy":
            from vit_colmap_tpu_torch.features.dummy_extractor import DummyExtractor

            self._extractors[key] = DummyExtractor(step=32, device=self.device)
        elif ecfg.extractor_type in ("sift", "colmap_sift"):
            from vit_colmap_tpu_torch.features.sift_extractor import SiftExtractor

            self._extractors[key] = SiftExtractor(max_keypoints=ecfg.max_keypoints,
                                                  device=self.device)
        elif ecfg.extractor_type == "hybrid":
            from vit_colmap_tpu_torch.features.hybrid_extractor import HybridExtractor

            self._extractors[key] = HybridExtractor(
                weights_path=ecfg.vit_weights_path,
                backbone=ecfg.backbone,
                max_keypoints=ecfg.max_keypoints,
                image_batch=ecfg.image_batch,
                pca_path=ecfg.pca_path,
                device=self.device,
            )
        elif ecfg.extractor_type == "trainable_vit":
            from vit_colmap_tpu_torch.features.trainable_vit_extractor import (
                TrainableViTExtractor,
            )

            # The reference's SfM defaults (20480 keypoints, NMS 1, threshold
            # 0.4), cut to the score-ranked budget sfm_max_keypoints.
            budget = ecfg.sfm_max_keypoints
            self._extractors[key] = TrainableViTExtractor(
                weights_path=ecfg.vit_weights_path,
                backbone=ecfg.backbone,
                num_keypoints=min(20480, budget) if budget else 20480,
                nms_radius=1,
                detection_threshold=0.4,
                image_batch=ecfg.image_batch,
                device=self.device,
            )
        else:
            from vit_colmap_tpu_torch.features.vit_extractor import ViTExtractor

            self._extractors[key] = ViTExtractor(
                weights_path=ecfg.vit_weights_path,
                backbone=ecfg.backbone,
                max_keypoints=ecfg.max_keypoints,
                image_batch=ecfg.image_batch,
                pca_path=ecfg.pca_path,
                transfer_format=ecfg.transfer_format,
                quantize=ecfg.quantize,
                device=self.device,
            )
        return self._extractors[key]

    def run(
        self,
        image_dir: Path,
        output_dir: Path,
        db_path: Path,
        dataset: Optional[str] = None,
        scene: Optional[str] = None,
        results_dir: Optional[Path] = None,
    ) -> Optional[dict]:
        self._check_extractor()
        image_dir, output_dir, db_path = Path(image_dir), Path(output_dir), Path(db_path)
        output_dir.mkdir(parents=True, exist_ok=True)
        db_path.parent.mkdir(parents=True, exist_ok=True)
        logger.info("Device: %s", self.device)
        logger.info("\n%s", self.config.summary())
        with trace():  # a torch.profiler trace when VIT_COLMAP_PROFILE_DIR is set
            report = self._run_stages(image_dir, output_dir, db_path, dataset, scene,
                                      results_dir, GLOBAL_TIMER)
        logger.info("\n%s", GLOBAL_TIMER.summary())
        return report

    def _run_stages(self, image_dir, output_dir, db_path, dataset, scene, results_dir,
                    timer) -> Optional[dict]:
        t0 = time.perf_counter()
        with timer.stage("extract"):
            extractor = self._make_extractor()
            extractor.extract(
                image_dir, db_path, self.config.camera.model, self.config.camera.params
            )
        t_extract = time.perf_counter() - t0
        with ColmapDatabase.open_database(db_path) as db:
            num_images = db.num_images
        if num_images == 0:
            logger.error("No images were processed; aborting")
            return None
        logger.info(
            "Extraction: %d images in %.2fs (%.2f img/s)",
            num_images, t_extract, num_images / max(t_extract, 1e-9),
        )

        t_match = 0.0
        stats = None
        if self.config.do_matching:
            from vit_colmap_tpu_torch.pipeline.match import match_exhaustive

            if self.config.extractor.extractor_type in SIGNED_DESCRIPTORS:
                self.config.matching.descriptor_encoding = "signed"
            t1 = time.perf_counter()
            with timer.stage("match+verify"):
                stats = match_exhaustive(
                    db_path,
                    self.config.matching,
                    device_descriptors=getattr(extractor, "device_cache", None),
                    device=self.device,
                )
            t_match = time.perf_counter() - t1

        t_recon = 0.0
        self.reconstructions = {}
        if self.config.do_reconstruction:
            from vit_colmap_tpu_torch.sfm.incremental import incremental_mapping

            t2 = time.perf_counter()
            with timer.stage("reconstruction"):
                self.reconstructions = incremental_mapping(
                    db_path, image_dir, output_dir / "sparse", self.config.reconstruction,
                    device=self.device)
            t_recon = time.perf_counter() - t2

        self._print_summary(db_path, t_extract, t_match, t_recon)
        if dataset and scene and results_dir:
            self.extract_and_export_metrics(db_path, output_dir, dataset, scene,
                                            results_dir)
        report = {
            "num_images": num_images,
            "extract_s": round(t_extract, 3),
            "match_verify_s": round(t_match, 3),
            "reconstruction_s": round(t_recon, 3),
            "total_s": round(t_extract + t_match + t_recon, 3),
        }
        if self.reconstructions:
            report["registered_images"] = sum(
                len(r.images) for r in self.reconstructions.values())
            report["points3d"] = sum(len(r.points3D) for r in self.reconstructions.values())
        if stats is not None:  # the split of the match+verify stage
            report.update(match_s=round(stats.match_seconds, 3),
                          verify_s=round(stats.verify_seconds, 3),
                          verify_chunks=dict(stats.verify_chunks))
        return report

    def _print_summary(self, db_path: Path, t_extract: float, t_match: float,
                       t_recon: float) -> None:
        with ColmapDatabase.open_database(db_path) as db:
            logger.info("=" * 60)
            logger.info("Pipeline summary")
            logger.info(
                "  [1] extraction    %.2fs — %d images, %d keypoints",
                t_extract, db.num_images, db.num_keypoints,
            )
            logger.info(
                "  [2] match+verify  %.2fs — %d matched pairs, %d verified, %d raw matches",
                t_match, db.num_matched_pairs, db.num_verified_pairs, db.num_matches,
            )
        # A failed metric read costs the summary one line, not the run.
        try:
            m = MetricsExtractor(db_path, db_path.parent).extract_matching_metrics(
                self.config.reconstruction.min_num_matches
            )
            logger.info(
                "      inlier ratio %.3f | verification rate %.1f%% | "
                "pairs >= %d inliers: %d | config dist %s",
                m.inlier_ratio, m.verification_rate,
                self.config.reconstruction.min_num_matches, m.pairs_above_threshold,
                m.config_distribution,
            )
        except Exception:
            logger.debug("matching-metric summary unavailable", exc_info=True)
        if self.reconstructions:
            logger.info(
                "  [3] reconstruction %.2fs — %d models, %d registered images, %d 3D points",
                t_recon, len(self.reconstructions),
                sum(len(r.images) for r in self.reconstructions.values()),
                sum(len(r.points3D) for r in self.reconstructions.values()),
            )
        logger.info("=" * 60)

    def extract_and_export_metrics(
        self,
        db_path: Path,
        output_dir: Path,
        dataset: str,
        scene: str,
        results_dir: Path,
    ) -> Optional[MetricsResult]:
        """Feature, matching and reconstruction metrics (the last run's
        models, none when reconstruction was skipped), written as
        ``{results_dir}/{dataset}/{scene}/{extractor}.json`` and appended to
        ``{results_dir}/summary.csv``; None, after logging the error, when
        they cannot be computed or written, so that ``run`` still returns
        its report."""
        try:
            result = MetricsExtractor(db_path, output_dir).extract_all_metrics(
                dataset=dataset,
                scene=scene,
                extractor_type=self.config.extractor.extractor_type,
                config=self.config.to_dict(),
                reconstructions=self.reconstructions or None,
            )
            export_metrics(result, results_dir)
            return result
        except Exception:
            logger.exception("Metrics extraction failed")
            return None


def main(argv: Optional[list[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        description="Run the ViT-COLMAP pipeline on the GPU (PyTorch/CUDA port)"
    )
    ap.add_argument("--images", required=True, type=Path)
    ap.add_argument("--output", required=True, type=Path)
    ap.add_argument("--db", default=Path("data/intermediate/database.db"), type=Path)
    ap.add_argument("--model", default=None, type=Path)
    ap.add_argument("--camera-model", default="SIMPLE_PINHOLE", type=str)
    ap.add_argument("--camera-params", default=None, type=str,
                    help="Comma-separated camera params override")
    ap.add_argument("--skip-matching", action="store_true")
    ap.add_argument("--skip-reconstruction", action="store_true")
    ap.add_argument("--skip-verification", action="store_true")
    ap.add_argument("--verbose", "-v", action="store_true")
    ap.add_argument("--use-colmap-sift", action="store_true")
    ap.add_argument(
        "--extractor", type=str, default=None,
        choices=["vit", "trainable_vit", "colmap_sift", "sift", "dummy", "hybrid"],
    )
    ap.add_argument("--vit-weights", type=Path, default=None)
    ap.add_argument("--backbone", type=str, default=None)
    ap.add_argument("--max-keypoints", type=int, default=None)
    ap.add_argument("--sfm-max-keypoints", type=int, default=None)
    ap.add_argument("--pca-path", type=Path, default=None,
                    help="persisted PCA projection (.npz), fit+saved on first use")
    ap.add_argument("--transfer-format", choices=["rgb", "yuv420", "yuv420c4"],
                    default=None)
    ap.add_argument("--quantize", choices=["none", "int8"], default=None)
    ap.add_argument("--min-num-matches", type=int, default=None)
    ap.add_argument("--shard-descriptors", action="store_true")
    ap.add_argument("--dataset", type=str, default=None)
    ap.add_argument("--scene", type=str, default=None)
    ap.add_argument("--export-metrics", type=Path, default=None)
    ap.add_argument("--profile-dir", type=Path, default=None,
                    help="write a torch.profiler trace (Chrome JSON) to this directory")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "PyTorch versions of the kernels)")
    args = ap.parse_args(argv)
    if args.profile_dir:
        os.environ["VIT_COLMAP_PROFILE_DIR"] = str(args.profile_dir)
    config = Config.from_args(args)
    Pipeline(config=config, device=args.device).run(
        image_dir=args.images,
        output_dir=args.output,
        db_path=args.db,
        dataset=args.dataset,
        scene=args.scene,
        results_dir=args.export_metrics,
    )
    logger.info("Pipeline complete!")


if __name__ == "__main__":
    main()
