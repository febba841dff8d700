"""Readings of the numbers that decide ``correct``, for setting their limits:
sound runs of a cell on many seeds and runs of its control (``--variant``),
all in one process, each a full run of the cell (set-up, window, check)
with a short window that keeps every batch it finishes.  ``--fault-seeds``
adds runs with a fault planted in the program (refinement skipped, for the
extract cells).

    python3 benchmark/tools/readings.py --workload vitb14.extract \\
        --seeds 5001-5012 --variant int8 --control-seeds 6001-6003 --seconds 6

Prints one JSON line a run, then for each number the largest sound reading,
the smallest control and fault readings and the control's ratio.  Not part
of the benchmark's own runs.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.harness import env  # noqa: E402

env.prepare(ROOT)

from benchmark.harness import manifest  # noqa: E402
from benchmark.harness.runner import run_cell  # noqa: E402


def seeds(text: str) -> list[int]:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return out


@contextlib.contextmanager
def planted(on: bool):
    """Refinement skipped where the extractor calls it, while ``on``."""
    if not on:
        yield
        return
    from vit_colmap_tpu_torch.features import vit_extractor

    orig = vit_extractor.quadratic_refine
    vit_extractor.quadratic_refine = lambda scores, xy: 0.0 * orig(scores, xy)
    try:
        yield
    finally:
        vit_extractor.quadratic_refine = orig


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=seeds, required=True)
    p.add_argument("--variant", default=None)
    p.add_argument("--control-seeds", type=seeds, default=[])
    p.add_argument("--fault-seeds", type=seeds, default=[])
    p.add_argument("--seconds", type=float, default=6.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    runs = [(None, s) for s in args.seeds] + [(args.variant, s) for s in args.control_seeds]
    runs += [("fault", s) for s in args.fault_seeds]
    readings = {None: {}, args.variant: {}, "fault": {}}
    for variant, seed in runs:
        cell = manifest.resolve(manifest.load(), args.workload)
        if cell.driver == "extract":
            cell.traffic["keep_share"] = 1.0
        t0 = time.perf_counter()
        with planted(variant == "fault"):
            r = run_cell(cell, seed, args.seconds, False, args.device, t0,
                         None if variant == "fault" else variant)
        r.pop("_check_lines")
        print(json.dumps({"variant": variant, "seed": seed, "correct": r["correct"],
                          "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                          "readings": r["_readings"],
                          "wall_s": time.perf_counter() - t0}), flush=True)
        for k, v in r["_readings"].items():
            readings[variant].setdefault(k, []).append(v)
    for k, sound in readings[None].items():
        lower = max(sound)
        control = readings.get(args.variant, {}).get(k)
        upper = min(control) if control else None
        fault = readings["fault"].get(k)
        print(json.dumps({"number": k, "lower": lower, "upper": upper,
                          "ratio": upper / lower if upper is not None and lower else None,
                          "fault_least": min(fault) if fault else None,
                          "sound": sound, "control": control, "fault": fault}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
