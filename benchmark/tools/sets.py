"""Two sets of runs of one cell, each run its own process as the driver
makes them, with the same seeds in both sets; then each metric's median
and quartile spread per set, and the bound five times the widest spread
would give.

    python3 benchmark/tools/sets.py --workload vitb14.extract --seeds 7001-7006 \\
        [--trace-seeds 7101-7103] [--seconds 20] [--sets 2]

Not part of the benchmark's own runs.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.harness import manifest  # noqa: E402
from benchmark.harness.stats import quartile_spread, trimmed  # noqa: E402
from benchmark.tools.readings import seeds  # noqa: E402


def run(workload: str, seed: int, seconds: float, trace: int) -> dict:
    cmd = [sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload", workload,
           "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace)]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, check=False)
    wall = time.perf_counter() - t0
    last = p.stdout.strip().splitlines()[-1] if p.stdout.strip() else ""
    try:
        r = json.loads(last)
    except json.JSONDecodeError:
        r = {"correct": None, "stderr": p.stderr[-3000:]}
    r.update(rc=p.returncode, seed=seed, trace=trace, wall_s=wall)
    info = [ln for ln in p.stderr.splitlines() if ln.startswith("[bench]")]
    r["info"] = info[-6:]
    return r


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=seeds, default=[])
    p.add_argument("--trace-seeds", type=seeds, default=[])
    p.add_argument("--seconds", type=float, default=None)
    p.add_argument("--sets", type=int, default=2)
    args = p.parse_args()
    seconds = args.seconds or manifest.load()["run_seconds"]
    sets = []
    for _ in range(args.sets if args.seeds else 0):
        rs = [run(args.workload, s, seconds, 0) for s in args.seeds]
        for r in rs:
            print(json.dumps(r), flush=True)
        sets.append(rs)
    for s in args.trace_seeds:
        print(json.dumps(run(args.workload, s, seconds, 1)), flush=True)
    if not sets:
        return 0
    names = sorted({k for rs in sets for r in rs for k in r.get("metrics", {})})
    for name in names:
        rows = []
        for rs in sets:
            vals = [r["metrics"][name]["value"] for r in rs if name in r.get("metrics", {})]
            if len(vals) >= 3:
                rows.append({"median": statistics.median(vals), "spread": quartile_spread(vals),
                             "spread_trimmed": quartile_spread(trimmed(vals))
                             if len(vals) >= 4 else None, "values": vals})
        widest = max((r["spread"] for r in rows), default=None)
        print(json.dumps({"metric": name, "sets": rows, "widest_spread": widest,
                          "bound_5x": None if widest is None else max(0.01, 5 * widest)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
