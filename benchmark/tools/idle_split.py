"""A cell's device-idle time split by the program phase the host was in,
read from the port's own ``vc.*`` spans (``harness/program_spans.py``),
and the cost of tracing: one process sets the cell up, then runs an
untraced window, a traced one and an untraced one again, each ``--seconds``
long.

    python3 benchmark/tools/idle_split.py --workload vitb14.match --seed 7 --seconds 10

Prints one JSON line: the units (batches or jobs) of each window and their
rates; for each ``vc.*`` span of the cell's layer its count, host and
device-idle milliseconds and synchronizing runtime calls a unit, and the
kernels launched inside it (kernel 1's or 2's launches counted); the
idle outside every span of the layer and inside the top span but outside
its phases (the split's remainder), by the phase before it; and the
cell's ``program_span`` metrics as the benchmark reads them.  Not
part of the benchmark's own runs.
"""

import argparse
import bisect
import json
import sys
import time
import types
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark.harness import env  # noqa: E402

env.cache_bytecode(ROOT)
env.prepare(ROOT)

from benchmark.harness import manifest  # noqa: E402
from benchmark.harness import program_spans as ps  # noqa: E402
from benchmark.harness.trace import Trace, profiled, span  # noqa: E402

# The driver's counter of the cell's unit, the layer's span prefix, its
# top span (one a unit) and the hand-written kernel whose launches are
# placed by phase (kernel 1 or kernel 2).
LAYERS = {"extract": ("batches", "vc.extract.", "vc.extract.batch", "attention_kernel"),
          "match": ("jobs", "vc.match.", "vc.match.job", "match_topk2_kernel")}


def timed_window(drv, unit: str, seconds: float, traced: bool):
    n0 = drv.counters()[unit]
    t0 = time.perf_counter()
    drv.window(seconds, traced)
    wall = time.perf_counter() - t0
    n = drv.counters()[unit] - n0
    return n, n / wall


def launched_in(trace, phases: list[tuple[int, int, str]], kernel: str) -> dict:
    """Device seconds, the commonest kernels and the count of ``kernel``
    by the phase whose span was open on the main thread when the work was
    launched (correlation ids)."""
    starts = [a for a, _, _ in phases]
    where = {}
    for e in trace.launches:
        if e[5] != trace.main_thread or not e[4]:
            continue
        i = bisect.bisect_right(starts, e[2]) - 1
        where[e[4]] = phases[i][2] if i >= 0 and e[2] < phases[i][1] else "no phase"
    out = defaultdict(lambda: {"device_s": 0.0, "kernels": defaultdict(int), "named": 0})
    for e in trace.device:
        ph = where.get(e[4], "no launch seen")
        out[ph]["device_s"] += (e[3] - e[2]) * 1e-9
        out[ph]["kernels"][e[0][:64]] += 1
        out[ph]["named"] += kernel in e[0]
    return {k: {"device_s": v["device_s"], kernel: v["named"],
                "top_kernels": sorted(v["kernels"].items(), key=lambda x: -x[1])[:5]}
            for k, v in out.items()}


def remainder_after(trace, top: str, child_spans, per: int) -> dict:
    """The split's remainder, the idle inside the top span but outside its
    phases, by the phase that ended last before it ("start" before the
    first), and the main thread's operators and runtime calls in it."""
    top_spans = ps.spans(trace, top)
    covered = ps.merge((a, b) for a, b, _ in child_spans)
    gaps = []  # the top spans less the phases
    for a, b in top_spans:
        cur = a
        for c, d in covered:
            if d <= cur or c >= b:
                continue
            if c > cur:
                gaps.append((cur, c))
            cur = max(cur, d)
        if cur < b:
            gaps.append((cur, b))
    ends = sorted((b, n) for _, b, n in child_spans)
    keys = [b for b, _ in ends]
    idle_gaps = ps.idle(trace)
    out = defaultdict(float)
    for a, b in gaps:
        i = bisect.bisect_right(keys, a) - 1
        label = ends[i][1] if i >= 0 and ends[i][0] >= a - 1 else "start"
        out[label] += ps.overlap_ns(idle_gaps, [(a, b)]) * 1e-6 / per
    # What the main thread ran in those gaps: operators and runtime calls.
    ops = defaultdict(int)
    for e in [*trace.host, *trace.launches]:
        if e[5] != trace.main_thread or e[0].startswith((ps.PREFIX, "bench.")):
            continue
        for a, b in gaps[max(0, bisect.bisect_right(gaps, (e[2],)) - 1):]:
            if a >= e[3]:
                break
            ops[e[0][:48]] += max(0, min(b, e[3]) - max(a, e[2]))
    top_ops = sorted(ops.items(), key=lambda x: -x[1])[:8]
    return {"after": dict(out), "ops_ms_per_unit": [[n, t * 1e-6 / per] for n, t in top_ops]}


def split(trace, unit_count: int, prefix: str, top: str, kernel: str) -> dict:
    names = sorted({e[0] for e in trace.host if e[0].startswith(prefix)})
    children = [n for n in names if n != top]
    per = max(unit_count, 1)
    phases = {}
    for n in names:
        count = sum(1 for e in trace.host if e[0] == n and trace.t0 <= e[2] < trace.t1)
        phases[n] = {"spans": count, "host_ms_per_unit": ps.host_ns(trace, n) * 1e-6 / per,
                     "idle_ms_per_unit": ps.idle_ns(trace, n) * 1e-6 / per}
    idle_total = ps.idle_ns(trace)
    under_children = sum(ps.idle_ns(trace, n) for n in children)
    in_layer = ps.idle_ns(trace, names)
    outside = idle_total - in_layer
    remainder = in_layer - ps.idle_ns(trace, children)
    child_spans = sorted((a, b, n) for n in children for a, b in ps.spans(trace, n))
    for n in names:
        phases[n]["syncs_per_unit"] = ps.syncs(trace, n) / per
    return {
        "window_s": trace.window_s, "busy_s": trace.busy_s(), "idle_s": idle_total * 1e-9,
        "phases": phases,
        "idle_s_under_phases": under_children * 1e-9,
        "idle_s_outside_layer": outside * 1e-9,
        "idle_s_in_top_outside_phases": remainder * 1e-9,
        "remainder_share_of_idle": remainder / idle_total if idle_total else None,
        "remainder_ms_per_unit": remainder_after(trace, top, child_spans, per),
        "syncs_per_unit": ps.syncs(trace, top) / per,
        "launched_in": launched_in(trace, child_spans, kernel),
    }


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    import torch

    cell = manifest.resolve(manifest.load(), args.workload)
    unit, prefix, top, kernel = LAYERS[cell.driver]
    mod = manifest.load_file_module(manifest.driver_path(cell.driver), "driver")
    drv = mod.Driver(cell.config, cell.traffic, args.seed, args.device)
    cuda = args.device.startswith("cuda")
    try:
        drv.setup()
        if cuda:
            torch.cuda.synchronize()
        before = timed_window(drv, unit, args.seconds, False)
        with profiled(cuda) as held:
            with span("bench.window", True):
                traced = timed_window(drv, unit, args.seconds, True)
        after = timed_window(drv, unit, args.seconds, False)
        trace = Trace(held.events)
        counters = dict(drv.counters(), **{unit: traced[0]})
        ctx = types.SimpleNamespace(trace=trace, counters=counters, config=cell.config,
                                    traffic=cell.traffic)
        metrics = {m["name"]: manifest.load_file_module(
            manifest.metric_path(m["name"]), "metric").read(ctx)
            for m in cell.per_layer if m["source"] == "program_span"}
        untraced = (before[1] + after[1]) / 2
        out = {"workload": args.workload, "seed": args.seed, "unit": unit,
               "units": {"untraced_before": before[0], "traced": traced[0],
                         "untraced_after": after[0]},
               "rate_per_s": {"untraced_before": before[1], "traced": traced[1],
                              "untraced_after": after[1]},
               "traced_rate_loss_share": 1 - traced[1] / untraced if untraced else None,
               "events": len(held.events), "metrics": metrics,
               **split(trace, traced[0], prefix, top, kernel),
               "card": env.nvidia_smi() if cuda else "none"}
        print(json.dumps(out), flush=True)
    finally:
        drv.cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main())
