#!/usr/bin/env python
"""Readings of the JAX package's two-view verification on the problems of
``chip_smoke.py``'s calibrated phase, from which that phase's ground-truth
bars (``CAL_BARS``) are set.

The same batch (``chip_smoke.calibrated_problems``: three inlier ratios,
512 correspondences each, both cameras calibrated) goes through
``vit_colmap_tpu.ops.ransac.estimate_two_view_batched`` with the default
5-point solver and 1,024 hypotheses, on the CPU; the script prints, per
inlier ratio, the mean recall of the true inliers, the CALIBRATED rate and
the median rotation error of the verified pairs, as one JSON line.

    python3 scripts/torch_verify_bars.py

The first call compiles the verification program (minutes on the CPU).
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> None:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import numpy as np

    jax.config.update("jax_platforms", "cpu")
    import chip_smoke
    from vit_colmap_tpu.ops.ransac import estimate_two_view_batched

    prob = chip_smoke.calibrated_problems(seed=0)
    P = len(prob["ratio"])
    t = time.perf_counter()
    res = estimate_two_view_batched(
        prob["pts1"], prob["pts2"], np.ones(prob["pts1"].shape[:2], bool), prob["K"],
        prob["K"], np.ones(P, bool), jax.random.split(jax.random.key(7), P),
        iters=chip_smoke.CAL_ITERS)
    config, n_inl, inl, qvec = (np.asarray(a) for a in (res.config, res.num_inliers,
                                                         res.inlier_mask, res.qvec))
    seconds = time.perf_counter() - t
    quality = chip_smoke.calibrated_quality(prob, config, n_inl, inl, qvec)
    print(json.dumps({"reference": "vit_colmap_tpu estimate_two_view_batched, CPU",
                      "pairs": P, "points": chip_smoke.CAL_POINTS,
                      "iters": chip_smoke.CAL_ITERS, "seconds_with_compile": seconds,
                      "quality": {str(k): v for k, v in quality.items()},
                      "missed_bars": chip_smoke.meets_bars(quality)}))


if __name__ == "__main__":
    main()
