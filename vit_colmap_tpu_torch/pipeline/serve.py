"""Persistent serving mode on the GPU: one process, many scenes.

Counterpart of ``vit_colmap_tpu/pipeline/serve.py``.  One ``Pipeline``
serves every job, so its extractor (model weights on the card, the PCA)
and the kernels it built stay warm across scenes: a job after the first
pays neither the model load nor the kernel build.

Usage::

    # jobs.jsonl: one {"image_dir": ..., "output_dir": ...} object per line
    python -m vit_colmap_tpu_torch.pipeline.serve --jobs jobs.jsonl [pipeline flags]

    # or stream jobs on stdin (newline-delimited JSON), e.g. from a queue:
    ... | python -m vit_colmap_tpu_torch.pipeline.serve --stdin

Each job may override ``db_path`` / ``dataset`` / ``scene`` /
``results_dir``; everything else (extractor type, camera model, matching
and reconstruction options) comes from the server's pipeline config.  A
stale database at a job's path is removed first; a job that fails is
logged and skipped, and the server goes on.  ``--device`` picks the torch
device (default: cuda; ``cpu`` runs the kernels' plain versions).  The
exit status is 1 when every job failed.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, Iterator, Optional

from vit_colmap_tpu_torch.pipeline.run_pipeline import Pipeline
from vit_colmap_tpu_torch.utils.config import Config

logger = logging.getLogger(__name__)


@dataclass
class SceneJob:
    """One reconstruction request."""

    image_dir: Path
    output_dir: Path
    db_path: Optional[Path] = None  # default: <output_dir>/database.db
    dataset: Optional[str] = None
    scene: Optional[str] = None
    results_dir: Optional[Path] = None

    @classmethod
    def from_dict(cls, d: dict) -> "SceneJob":
        known = set(cls.__dataclass_fields__)
        extra = set(d) - known
        if extra:
            raise ValueError(f"Unknown job fields: {sorted(extra)}")
        if "image_dir" not in d or "output_dir" not in d:
            raise ValueError("Job needs at least image_dir and output_dir")
        kw = dict(d)
        for k in ("image_dir", "output_dir", "db_path", "results_dir"):
            if kw.get(k) is not None:
                kw[k] = Path(kw[k])
        return cls(**kw)


@dataclass
class JobResult:
    job: SceneJob
    ok: bool
    wall_s: float
    report: Optional[dict] = None
    error: Optional[str] = None

    def to_dict(self) -> dict:
        d = {
            "image_dir": str(self.job.image_dir),
            "output_dir": str(self.job.output_dir),
            "ok": self.ok,
            "wall_s": round(self.wall_s, 3),
        }
        if self.report:
            d.update(self.report)
        if self.error:
            d["error"] = self.error
        return d


@dataclass
class PipelineServer:
    """Long-lived pipeline host: scenes share one process, one Pipeline and
    its warm extractor."""

    config: Config
    device: object = None
    results: list[JobResult] = field(default_factory=list)

    def __post_init__(self) -> None:
        self.pipeline = Pipeline(self.config, device=self.device)

    def run_job(self, job: SceneJob) -> JobResult:
        db_path = job.db_path or (Path(job.output_dir) / "database.db")
        if db_path.exists():
            # The pipeline appends to an existing database; a serving
            # process owns its scratch space, so a stale one is removed.
            db_path.unlink()
        t0 = time.perf_counter()
        try:
            report = self.pipeline.run(
                image_dir=job.image_dir,
                output_dir=job.output_dir,
                db_path=db_path,
                dataset=job.dataset,
                scene=job.scene,
                results_dir=job.results_dir,
            )
            res = JobResult(job, ok=report is not None,
                            wall_s=time.perf_counter() - t0, report=report)
        except Exception as exc:  # skip and continue; the server survives
            logger.exception("Job failed: %s", job.image_dir)
            res = JobResult(job, ok=False, wall_s=time.perf_counter() - t0,
                            error=f"{type(exc).__name__}: {exc}")
        self.results.append(res)
        logger.info("Job %d done in %.2fs (ok=%s): %s",
                    len(self.results), res.wall_s, res.ok, job.image_dir)
        return res

    def serve(self, jobs: Iterable[SceneJob]) -> list[JobResult]:
        for job in jobs:
            self.run_job(job)
        return self.results


def _iter_jobs(lines: Iterable[str]) -> Iterator[SceneJob]:
    for lineno, line in enumerate(lines, 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            yield SceneJob.from_dict(json.loads(line))
        except (json.JSONDecodeError, ValueError, TypeError) as exc:
            logger.error("Bad job on line %d (%s); skipped", lineno, exc)


def main(argv: Optional[list[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        description="Serve reconstruction jobs from one warm GPU process (PyTorch/CUDA port)"
    )
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--jobs", type=Path, help="JSONL job file")
    src.add_argument("--stdin", action="store_true",
                     help="read JSONL jobs from stdin until EOF")
    ap.add_argument("--extractor", type=str, default="sift",
                    choices=["vit", "trainable_vit", "colmap_sift", "sift", "dummy", "hybrid"])
    ap.add_argument("--camera-model", default="SIMPLE_PINHOLE", type=str)
    ap.add_argument("--camera-params", default=None, type=str)
    ap.add_argument("--vit-weights", type=Path, default=None)
    ap.add_argument("--backbone", type=str, default=None)
    ap.add_argument("--max-keypoints", type=int, default=None)
    ap.add_argument("--pca-path", type=Path, default=None)
    ap.add_argument("--transfer-format", choices=["rgb", "yuv420", "yuv420c4"], default=None)
    ap.add_argument("--quantize", choices=["none", "int8"], default=None)
    ap.add_argument("--min-num-matches", type=int, default=None)
    ap.add_argument("--skip-matching", action="store_true")
    ap.add_argument("--skip-reconstruction", action="store_true")
    ap.add_argument("--skip-verification", action="store_true")
    ap.add_argument("--report-json", type=Path, default=None,
                    help="write per-job results as JSON here at exit")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "PyTorch versions of the kernels)")
    ap.add_argument("--verbose", "-v", action="store_true")
    args = ap.parse_args(argv)
    # Config.from_args reads every pipeline flag this parser lacks with a
    # default, so the mapping is shared.
    config = Config.from_args(args)

    server = PipelineServer(config, device=args.device)
    lines: Iterable[str] = sys.stdin if args.stdin else args.jobs.read_text().splitlines()
    server.serve(_iter_jobs(lines))

    ok = sum(r.ok for r in server.results)
    logger.info("Served %d jobs (%d ok)", len(server.results), ok)
    if args.report_json:
        args.report_json.parent.mkdir(parents=True, exist_ok=True)
        args.report_json.write_text(json.dumps([r.to_dict() for r in server.results], indent=2))
    if server.results and ok == 0:
        sys.exit(1)


if __name__ == "__main__":
    main()
