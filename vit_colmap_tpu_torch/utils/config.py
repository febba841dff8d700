"""Pipeline configuration: the port's own copy of ``vit_colmap_tpu/utils/
config.py``, with the same dataclasses, fields and defaults, so a config
tree and its CLI flags mean the same thing in both packages.  Every field
the JAX package reads drives the port's code too (none raises), except two
the port accepts without effect: ``MatchingConfig.verification_prewarm``
(nothing to precompile) and ``ReconstructionConfig.ba_coarse_buckets`` (no
shape buckets).  ``ExtractorConfig.dtype`` and ``CameraConfig.width`` /
``height`` are read by neither package.
"""

from __future__ import annotations

import logging
from dataclasses import asdict, dataclass, field
from typing import Optional


@dataclass
class LogConfig:
    level: int = logging.INFO
    format: str = "[%(asctime)s][%(filename)s:%(lineno)d][%(levelname)s] %(message)s"
    datefmt: str = "%H:%M:%S"

    def apply(self) -> None:
        logging.basicConfig(
            level=self.level, format=self.format, datefmt=self.datefmt, force=True
        )


@dataclass
class CameraConfig:
    model: str = "SIMPLE_PINHOLE"
    width: Optional[int] = None
    height: Optional[int] = None
    params: Optional[list[float]] = None

    def get_default_params(self, width: int, height: int) -> list[float]:
        if self.params is not None:
            return self.params
        f = float(max(width, height))
        cx, cy = width / 2.0, height / 2.0
        if self.model == "SIMPLE_PINHOLE":
            return [f, cx, cy]
        if self.model == "PINHOLE":
            return [f, f, cx, cy]
        if self.model == "SIMPLE_RADIAL":
            return [f, cx, cy, 0.0]
        if self.model == "RADIAL":
            return [f, cx, cy, 0.0, 0.0]
        raise ValueError(f"Unsupported camera model: {self.model}")


@dataclass
class MatchingConfig:
    """COLMAP SIFT-matcher semantics: ratio 0.8, max angular distance 0.7,
    mutual cross-check."""

    max_ratio: float = 0.8
    max_distance: float = 0.7
    cross_check: bool = True
    max_num_matches: int = 32768
    # "unsigned" (SIFT-style) or "signed" ([-1, 1] <-> [0, 255], ViT family)
    descriptor_encoding: str = "unsigned"
    pair_batch: int = 16  # image pairs matched per batch
    use_pallas: Optional[bool] = None  # None/True: the kernel; False: match_pairs_batched
    shard_descriptors: bool = False
    # Geometric verification (ops/ransac.py)
    do_verification: bool = True
    ransac_max_error_px: float = 4.0
    ransac_iters: int = 1024
    ransac_confidence: float = 0.999
    min_num_inliers: int = 15
    essential_solver: str = "5pt"
    verify_pair_batch: int = 64
    five_point_chunk: int = 16
    # Accepted for the reference's config tree and without effect here: the
    # reference pre-compiles its verification programs while extraction
    # runs; the port runs eagerly and has nothing to compile.
    verification_prewarm: bool = True


@dataclass
class ReconstructionConfig:
    """Incremental-mapper settings (``sfm/incremental.py``).  The port does
    not pad its problems to shape buckets, so ``ba_coarse_buckets`` has no
    effect; ``ba_unified_iters`` (> 0) sets every BA call's LM budget, and
    ``ba_solver`` picks "schur" (dense reduced camera system) or "cg"."""

    min_num_matches: int = 15
    multiple_models: bool = True
    max_models: int = 50
    ba_local_iters: int = 25
    ba_global_iters: int = 50
    ba_local_inner_iters: int = 12
    ba_local_cg_iters: int = 20
    ba_global_cg_iters: int = 50
    ba_solver: str = "schur"
    ba_coarse_buckets: bool = True
    ba_unified_iters: int = 50
    ba_refine_focal: bool = True
    ba_refine_extra_params: bool = True
    local_ba_num_images: int = 6
    global_ba_growth: float = 1.3
    min_triangulation_angle_deg: float = 1.5
    filter_max_reproj_error_px: float = 4.0


@dataclass
class ExtractorConfig:
    extractor_type: str = "vit"
    vit_weights_path: Optional[str] = None
    backbone: str = "vitb14"
    max_keypoints: int = 4096
    sfm_max_keypoints: int = 4096
    image_batch: int = 2  # images per backbone batch
    dtype: str = "bfloat16"
    pca_path: Optional[str] = None  # persisted PCA projection (.npz)
    transfer_format: str = "rgb"
    quantize: str = "none"


@dataclass
class Config:
    log: LogConfig = field(default_factory=LogConfig)
    camera: CameraConfig = field(default_factory=CameraConfig)
    extractor: ExtractorConfig = field(default_factory=ExtractorConfig)
    matching: MatchingConfig = field(default_factory=MatchingConfig)
    reconstruction: ReconstructionConfig = field(default_factory=ReconstructionConfig)
    do_matching: bool = True
    do_reconstruction: bool = True

    def __post_init__(self) -> None:
        self.log.apply()

    @classmethod
    def from_args(cls, args) -> "Config":
        config = cls()
        if getattr(args, "camera_model", None):
            config.camera.model = args.camera_model
        if getattr(args, "camera_params", None):
            config.camera.params = [float(p) for p in args.camera_params.split(",")]
        if getattr(args, "extractor", None):
            config.extractor.extractor_type = args.extractor
        elif getattr(args, "use_colmap_sift", False):
            config.extractor.extractor_type = "colmap_sift"
        if getattr(args, "vit_weights", None):
            config.extractor.vit_weights_path = str(args.vit_weights)
        elif getattr(args, "model", None):
            config.extractor.vit_weights_path = str(args.model)
        if getattr(args, "backbone", None):
            config.extractor.backbone = args.backbone
        if getattr(args, "max_keypoints", None):
            config.extractor.max_keypoints = int(args.max_keypoints)
        if getattr(args, "sfm_max_keypoints", None) is not None:
            config.extractor.sfm_max_keypoints = int(args.sfm_max_keypoints)
        if getattr(args, "pca_path", None):
            config.extractor.pca_path = str(args.pca_path)
        if getattr(args, "transfer_format", None):
            config.extractor.transfer_format = args.transfer_format
        if getattr(args, "quantize", None):
            config.extractor.quantize = args.quantize
        if getattr(args, "shard_descriptors", False):
            config.matching.shard_descriptors = True
        if getattr(args, "skip_matching", False):
            config.do_matching = False
        if getattr(args, "skip_reconstruction", False):
            config.do_reconstruction = False
        if getattr(args, "skip_verification", False):
            config.matching.do_verification = False
        if getattr(args, "min_num_matches", None):
            config.reconstruction.min_num_matches = int(args.min_num_matches)
        if getattr(args, "verbose", False):
            config.log.level = logging.DEBUG
            config.log.apply()
        return config

    def summary(self) -> str:
        lines = [
            "Configuration:",
            f"  Extractor: {self.extractor.extractor_type}",
            f"  Backbone: {self.extractor.backbone}",
            f"  Camera model: {self.camera.model}",
            f"  Matching: {'enabled' if self.do_matching else 'disabled'}",
            f"  Verification: {'enabled' if self.matching.do_verification else 'disabled'}",
            f"  Reconstruction: {'enabled' if self.do_reconstruction else 'disabled'}",
            f"  Min matches: {self.reconstruction.min_num_matches}",
        ]
        return "\n".join(lines)

    def to_dict(self) -> dict:
        d = asdict(self)
        d.pop("log", None)
        return d
