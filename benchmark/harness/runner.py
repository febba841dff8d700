"""One run of one cell: set-up, the measured window (traced or not), the
metrics, the check against the plain reference, and the result line.

The driver of the cell's traffic mix (``drivers/<driver>.py``) owns the
program and the inputs; the runner owns the clock, the trace and the
reporting.  Per-layer metrics are read by ``metrics/<name>.py`` from the
trace and the driver's counters.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from dataclasses import dataclass

from benchmark.harness import env, manifest
from benchmark.harness.checks import Check
from benchmark.harness.trace import Trace, profiled, span


@dataclass
class Context:
    """What a per-layer reader may read."""

    trace: Trace
    counters: dict
    config: dict
    traffic: dict


# The part of a traced run's window that the profiler records: its events
# grow with the work done (about 6 million in 51 s of vitb14.extract), and
# the run, the reading of the trace with it, has to end within 360 s.
TRACE_SECONDS = 10.0


def log(*parts) -> None:
    print("[bench]", *parts, file=sys.stderr, flush=True)


def run_cell(cell: manifest.Cell, seed: int, seconds: float, traced: bool, device: str,
             t0: float, variant: str | None = None, phases=None) -> dict:
    """Run ``cell`` once and return its result object (without the
    forbidden-module check, which ``main`` makes last).  Set-up runs from
    ``t0``; ``phases`` are (label, time) marks already passed in it, which
    the run logs with the driver's own."""
    import torch

    cuda = device.startswith("cuda")
    mod = manifest.load_file_module(manifest.driver_path(cell.driver), "driver")
    drv = mod.Driver(cell.config, cell.traffic, seed, device, variant)
    try:
        marks = [("start", t0), *(phases or []), ("driver", time.perf_counter())]
        drv.setup(lambda label: marks.append((label, time.perf_counter())))
        if cuda:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        marks.append(("synchronized", t0 + setup_s))
        log("setup phases s", {b[0]: round(b[1] - a[1], 4) for a, b in zip(marks, marks[1:])})
        trace = None
        if traced:
            part = min(seconds, TRACE_SECONDS)
            with profiled(cuda) as held:
                with span("bench.window", True):
                    drv.window(part, True)
                t_stop = time.perf_counter()
                counters = drv.counters()
            t_read = time.perf_counter()
            trace = Trace(held.events)
            t_reduced = time.perf_counter()
            if seconds > part:  # the rest of the run's window, untraced
                drv.window(seconds - part, False)
        else:
            drv.window(seconds, False)
        metrics = {}
        if not traced:
            values = {"setup_s": setup_s, **drv.end_to_end()}
            for m in cell.end_to_end:
                metrics[m["name"]] = {"value": manifest.value_of(m["name"], values),
                                      "unit": m["unit"]}
        dev_info = {"platform": "gpu" if cuda else "cpu",
                    "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                    "count": cell.chips,
                    "memory_peak_bytes": torch.cuda.max_memory_allocated(0) if cuda else 0}
        result = {"correct": False, "attempted": drv.attempted, "failed": drv.failed,
                  "metrics": metrics, "device": dev_info}
        if traced:
            ctx = Context(trace, counters, cell.config, cell.traffic)
            for m in cell.per_layer:
                reader = manifest.load_file_module(manifest.metric_path(m["name"]), "metric")
                value = reader.read(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            dev_info["busy_s"] = trace.busy_s()
            dev_info["window_s"] = trace.window_s
            result["breakdown"] = {"device_ops": trace.top_device_ops(10),
                                   "idle_gaps": trace.idle_by_host(10)}
            log("trace: events", len(held.events), "s to stop and collect", t_read - t_stop,
                "s to reduce", t_reduced - t_read, "and to read the metrics",
                time.perf_counter() - t_reduced - (seconds - part))
        log("card", env.nvidia_smi() if cuda else "none")
        log("max_memory_allocated", dev_info["memory_peak_bytes"])
        log("setup_s", setup_s, "window requests", drv.attempted, "failed", drv.failed)
        if len(drv.request_s) > 1:
            log("request seconds: quartiles", statistics.quantiles(drv.request_s, n=4),
                "max", max(drv.request_s))
        for err in drv.errors[:1]:
            log("first failure:\n" + err)
        drv.release()
        t_ref = time.perf_counter()
        readings = drv.judge()
        log("reference and check s", time.perf_counter() - t_ref)
    finally:
        drv.cleanup()
    readings = [Check(name, value, cell.limits.get(name)) for name, value in readings.items()]
    checks = [c for c in readings if c.limit is not None]
    result["correct"] = drv.failed == 0 and bool(checks) and all(c.ok for c in checks)
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    result["_check_lines"] = [c.line() for c in checks]
    result["_readings"] = {c.name: c.value for c in readings}
    return result


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--variant", default=None,
                   help="a lower-precision control in the program's place (not for the "
                        "benchmark's own runs): int8 for extraction, tf32 or bf16 for matching")
    return p.parse_args(argv)


def main(argv, t0: float) -> int:
    args = parse(argv)
    cell = manifest.resolve(manifest.load(), args.workload)
    phases = [("python", time.perf_counter())]
    import torch

    phases.append(("import_torch", time.perf_counter()))
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"needs {cell.chips} CUDA device(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    torch.cuda.init()
    phases.append(("cuda_init", time.perf_counter()))
    io0 = env.io_counts()
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t0,
                      args.variant, phases)
    found = env.forbidden_loaded()
    if found:
        log("forbidden modules loaded:", ", ".join(found))
        return 4
    io1 = env.io_counts()
    log("bytes written by this run:", {k: io1[k] - io0.get(k, 0) for k in io1})
    result.pop("_readings")
    lines = result.pop("_check_lines")
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    checks = result.pop("checks")
    result["checks"] = checks  # the compared numbers come last
    print(json.dumps(result), flush=True)
    return 0
