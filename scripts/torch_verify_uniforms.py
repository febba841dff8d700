#!/usr/bin/env python
"""Where the calibrated batch's quality spread comes from: the port's
two-view verification on the JAX package's uniforms, beside the JAX package
itself and the port on its own uniforms, all on the CPU.

The batch is ``chip_smoke.calibrated_problems(seed=0)`` (63 pairs, inlier
ratios 0.9 / 0.5 / 0.3, 512 correspondences, both cameras calibrated).  The
JAX package verifies it with lane keys ``split(key(7), 63)``, as
``scripts/torch_verify_bars.py`` does; the port verifies it (a) on the
uniforms those keys draw, laid out as the port's ``RansacUniforms`` (the
layout of ``tests/test_torch_ransac.py``), and (b) on its own uniforms from
``torch.Generator().manual_seed(7)``, as ``chip_smoke.py`` draws them.  If
(a) equals the JAX package lane by lane, a gap between (b) and the JAX
package is the spread of the samples, not a fault of the port.

    python3 scripts/torch_verify_uniforms.py    # about 5 min on the CPU

Prints one JSON line: per inlier ratio the recall, the CALIBRATED rate and
the median rotation error of each run, and the lanes where (a) and the JAX
package differ.
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def jax_uniforms(key, iters: int):
    """The uniforms the JAX package's ``estimate_two_view`` draws from
    ``key`` (5-point solver on), in the port's layout, for one lane."""
    import jax
    import numpy as np
    import torch

    from vit_colmap_tpu_torch.ops import ransac

    plan = ransac.chunk_plan(iters, five_point=True)
    kf, kh, ke = jax.random.split(key, 3)
    keys = {"f": kf, "h": kh}
    keys["e"], keys["e5"] = jax.random.split(ke)
    streams = {}
    for name, (n, chunk, m, start) in plan.items():
        streams[name] = torch.from_numpy(np.stack([
            np.asarray(jax.random.uniform(
                jax.random.fold_in(keys[name], start + s * chunk), (chunk, m)))
            for s in range(n)]))
    return ransac.RansacUniforms(f=streams["f"], h=streams["h"], e=streams["e"],
                                 e5=streams["e5"])


def main() -> None:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import numpy as np
    import torch

    jax.config.update("jax_platforms", "cpu")
    import chip_smoke
    from vit_colmap_tpu.ops.ransac import estimate_two_view_batched as jax_batched
    from vit_colmap_tpu_torch.ops import ransac

    prob = chip_smoke.calibrated_problems(seed=0)
    P = len(prob["ratio"])
    iters = chip_smoke.CAL_ITERS
    lane_keys = jax.random.split(jax.random.key(7), P)
    out = {"pairs": P, "points": chip_smoke.CAL_POINTS, "iters": iters}

    def quality(res):
        return chip_smoke.calibrated_quality(prob, res["config"], res["num_inliers"],
                                             res["inlier_mask"], res["qvec"])

    t = time.perf_counter()
    ref = jax_batched(prob["pts1"], prob["pts2"], np.ones(prob["pts1"].shape[:2], bool),
                      prob["K"], prob["K"], np.ones(P, bool), lane_keys, iters=iters)
    ref = {k: np.asarray(v) for k, v in ref._asdict().items()}
    out["jax_seconds_with_compile"] = time.perf_counter() - t

    host = [torch.from_numpy(a) for a in (prob["pts1"], prob["pts2"],
                                          np.ones(prob["pts1"].shape[:2], bool),
                                          prob["K"], prob["K"], np.ones(P, bool))]

    def port(uniforms):
        res = ransac.estimate_two_view_batched(*host, uniforms, iters=iters,
                                               five_point=True)
        return {k: v.numpy() for k, v in res._asdict().items()}

    lanes = [jax_uniforms(k, iters) for k in lane_keys]
    injected = ransac.RansacUniforms(*(torch.stack(parts) for parts in zip(*lanes)))
    t = time.perf_counter()
    port_jax_u = port(injected)
    out["port_jax_uniforms_seconds"] = time.perf_counter() - t
    port_own_u = port(ransac.draw_uniforms(P, torch.Generator().manual_seed(7),
                                           iters=iters, five_point=True))

    for name, res in (("jax", ref), ("port_jax_uniforms", port_jax_u),
                      ("port_own_uniforms", port_own_u)):
        out[name] = {str(k): v for k, v in quality(res).items()}
    diff = {
        "config": np.nonzero(ref["config"] != port_jax_u["config"])[0].tolist(),
        "num_inliers": np.nonzero(ref["num_inliers"] != port_jax_u["num_inliers"])[0].tolist(),
        "qvec_max_abs": float(np.abs(np.abs(ref["qvec"]) - np.abs(port_jax_u["qvec"])).max()),
    }
    out["lanes_differing_port_jax_uniforms_vs_jax"] = diff
    print(json.dumps(out))


if __name__ == "__main__":
    main()
