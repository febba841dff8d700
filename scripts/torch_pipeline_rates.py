#!/usr/bin/env python3
"""Warm extraction and matching rates of the port's ``Pipeline.run``, repeated.

    python3 scripts/torch_pipeline_rates.py [--runs 7] [--root DIR]

``chip_smoke.py`` keeps one warm ``Pipeline.run`` per call, so its rates
carry the host's noise.  This script drives the same workload
(``chip_smoke.slice_phase``: 8 synthetic 1190 x 1596 PNGs, seeded random
ViT-B/14 weights, 4096 keypoints, the 28 pairs in one matching batch; the
first run builds the kernels and fits the PCA), then runs ``Pipeline.run``
``--runs`` more times on the same pipeline with nothing in between, and
prints each run's extraction and matching seconds and their medians as one
JSON line.  ``--root`` names the checkout whose ``chip_smoke.py`` and
``vit_colmap_tpu_torch`` are imported (default: the one holding this
script), so that two trees can be compared in one call on one card.
Needs one CUDA GPU and nvcc.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import tempfile
from pathlib import Path


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--runs", type=int, default=7)
    parser.add_argument("--root", type=Path, default=Path(__file__).resolve().parent.parent)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    root = args.root.resolve()
    sys.path.insert(0, str(root))
    import chip_smoke

    runs = []
    with tempfile.TemporaryDirectory(prefix="pipeline_rates_") as tmp:
        work = Path(tmp)
        pipeline, _, _ = chip_smoke.slice_phase(work)
        for i in range(args.runs):
            chip_smoke.sync()
            report = pipeline.run(work / "images", work / "out", work / f"run{i + 2}.db")
            chip_smoke.sync()
            runs.append({"extract_s": report["extract_s"], "match_s": report["match_verify_s"]})
    extract = statistics.median(r["extract_s"] for r in runs)
    match = statistics.median(r["match_s"] for r in runs)
    print(json.dumps({
        "root": str(root),
        "runs": runs,
        "median_extract_s": extract,
        "median_extract_img_per_s": chip_smoke.NUM_IMAGES / extract,
        "median_match_s": match,
        "card": chip_smoke.nvidia_smi("name,power.limit"),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
