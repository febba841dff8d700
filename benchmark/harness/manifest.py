"""``BENCHMARK.json``: loading, checking, and resolving a cell to the files
that hold its configuration, its traffic mix, its driver, its limits and its
per-layer metric readers.  Everything is found by name, so a cell, a mix or
a metric is added with new files and new entries alone.

A metric named ``<quantity>.<part>`` is a quantity split by cells, so that
each part can carry a bound or move an end-to-end metric of its own: where
no reader file has the whole name, the reader of ``<quantity>`` reads it,
and a driver's value of ``<quantity>`` is its value."""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES_E2E = ("host_clock", "device_trace")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
            "per_layer"}


def traffic_path(name: str) -> Path:
    return BENCH_DIR / "traffic" / f"{name}.json"


def driver_path(name: str) -> Path:
    return BENCH_DIR / "drivers" / f"{name}.py"


def limits_path(cell: str) -> Path:
    return BENCH_DIR / "limits" / f"{cell}.json"


def quantities(name: str) -> list[str]:
    """``a.b.c`` -> ``["a.b.c", "a.b", "a"]``: the name, then the quantities
    it splits, longest first."""
    parts = name.split(".")
    return [".".join(parts[:n]) for n in range(len(parts), 0, -1)]


def metric_path(name: str) -> Path:
    """The reader of metric ``name``: ``metrics/<name>.py``, or that of the
    longest quantity it splits that has one."""
    for q in quantities(name):
        p = BENCH_DIR / "metrics" / f"{q}.py"
        if p.is_file():
            return p
    return BENCH_DIR / "metrics" / f"{name}.py"


def value_of(name: str, values: dict):
    """A driver's value of metric ``name`` or of the quantity it splits."""
    for q in quantities(name):
        if q in values:
            return values[q]
    raise KeyError(name)


def load_file_module(path: Path, tag: str):
    """Import a file of the benchmark by its path (metric names hold dots,
    so they are not importable as dotted module names)."""
    spec = importlib.util.spec_from_file_location(f"bench_{tag}_{path.stem}", path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load(path: Path | None = None) -> dict:
    return json.loads((path or ROOT / "BENCHMARK.json").read_text())


def reports(metric: dict, cell: str) -> bool:
    """Whether ``cell`` reports ``metric`` (no ``workloads`` key: every cell)."""
    return "workloads" not in metric or cell in metric["workloads"]


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]

    @property
    def driver(self) -> str:
        return self.traffic["driver"]


def resolve(manifest: dict, workload: str) -> Cell:
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"unknown workload {workload!r}; cells: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = json.loads((ROOT / configs[w["config"]]["file"]).read_text())
    traffic = json.loads(traffic_path(w["traffic"]).read_text())
    return Cell(
        name=workload,
        chips=int(w["chips"]),
        config=config,
        traffic=traffic,
        limits=json.loads(limits_path(workload).read_text()),
        end_to_end=[m for m in manifest["end_to_end"] if reports(m, workload)],
        per_layer=[m for m in manifest["per_layer"] if reports(m, workload)],
    )


def limit_problems(cell: str, driver: str) -> list[str]:
    """A cell's limits file has to exist and give a limit of 0 or more to one
    or more of the numbers that its driver reads, and to nothing else."""
    lp = limits_path(cell)
    if not lp.is_file():
        return [f"limits file {lp.name} missing"]
    limits = json.loads(lp.read_text())
    numbers = load_file_module(driver_path(driver), "driver").NUMBERS
    out = [f"{cell} limits {k}, which driver {driver} does not compare"
           for k in limits if k not in numbers]
    out += [f"{cell} limit {k} {v!r}" for k, v in limits.items()
            if not isinstance(v, (int, float)) or v < 0]
    if not limits:
        out.append(f"{cell} has no limit")
    return out


def problems(manifest: dict) -> list[str]:
    """What in ``manifest`` breaks the benchmark's contract or fails to
    resolve to a file; empty when all is well."""
    out: list[str] = []
    if set(manifest) != TOP_KEYS:
        out.append(f"top-level keys {sorted(manifest)}")

    def name_ok(n, what):
        if not isinstance(n, str) or not NAME_RE.match(n):
            out.append(f"{what} name {n!r}")

    def line_ok(s, what):
        if not isinstance(s, str) or not 1 <= len(s) <= 200 or "\n" in s or "\t" in s:
            out.append(f"{what} {s!r}")

    configs = {c["name"]: c for c in manifest["configs"]}
    for c in manifest["configs"]:
        name_ok(c["name"], "config")
        line_ok(c["source"], "config source")
        for k in c["reduced"]:
            name_ok(k, "reduced key")
        if set(c) != {"name", "source", "file", "reduced", "why"}:
            out.append(f"config {c['name']} keys {sorted(c)}")
        if not (ROOT / c["file"]).is_file():
            out.append(f"config file {c['file']} missing")
    used_configs = set()
    pairs = set()
    for w in manifest["workloads"]:
        name_ok(w["name"], "workload")
        name_ok(w["traffic"], "traffic")
        line_ok(w["why"], "why")
        if set(w) != {"name", "config", "traffic", "chips", "why"}:
            out.append(f"workload {w['name']} keys {sorted(w)}")
        if w["config"] not in configs:
            out.append(f"workload {w['name']} config {w['config']} unknown")
        used_configs.add(w["config"])
        if (w["config"], w["traffic"]) in pairs:
            out.append(f"pair {w['config']}, {w['traffic']} twice")
        pairs.add((w["config"], w["traffic"]))
        if w["chips"] not in (1, 4):
            out.append(f"workload {w['name']} chips {w['chips']}")
        tp = traffic_path(w["traffic"])
        if not tp.is_file():
            out.append(f"traffic file {tp.name} missing")
        elif not driver_path(json.loads(tp.read_text())["driver"]).is_file():
            out.append(f"driver of {tp.name} missing")
        else:
            out.extend(limit_problems(w["name"], json.loads(tp.read_text())["driver"]))
    for c in configs:
        if c not in used_configs:
            out.append(f"config {c} used by no cell")
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    if "setup_s" not in e2e:
        out.append("no setup_s")
    for m in manifest["end_to_end"]:
        if m["source"] not in SOURCES_E2E:
            out.append(f"{m['name']} source {m['source']}")
        if not 0 < m["bound"] <= 0.25:
            out.append(f"{m['name']} bound {m['bound']}")
        if set(m) - {"workloads"} != {"name", "unit", "better", "bound", "source"}:
            out.append(f"end-to-end {m['name']} keys {sorted(m)}")
    for m in manifest["per_layer"]:
        if m["source"] not in SOURCES:
            out.append(f"{m['name']} source {m['source']}")
        line_ok(m["layer"], "layer")
        if set(m) - {"workloads"} != {"name", "unit", "better", "source", "layer", "moves"}:
            out.append(f"per-layer {m['name']} keys {sorted(m)}")
        if m["moves"] not in e2e:
            out.append(f"{m['name']} moves unknown {m['moves']}")
        if not metric_path(m["name"]).is_file():
            out.append(f"reader {m['name']}.py missing")
    for m in [*manifest["end_to_end"], *manifest["per_layer"]]:
        name_ok(m["name"], "metric")
        if not UNIT_RE.match(m["unit"]):
            out.append(f"{m['name']} unit {m['unit']!r}")
        if m["better"] not in ("lower", "higher"):
            out.append(f"{m['name']} better {m['better']}")
    names = [m["name"] for m in [*manifest["end_to_end"], *manifest["per_layer"]]]
    for what, ns in (("metric", names), ("workload", [w["name"] for w in manifest["workloads"]]),
                     ("config", [c["name"] for c in manifest["configs"]])):
        if len(ns) != len(set(ns)):
            out.append(f"duplicate {what} names")
    cells = [w["name"] for w in manifest["workloads"]]
    for m in manifest["per_layer"]:
        for cell in (m.get("workloads") or cells):
            if cell not in cells:
                out.append(f"{m['name']} lists unknown cell {cell}")
            elif m["moves"] in e2e and not reports(e2e[m["moves"]], cell):
                out.append(f"{m['name']} in {cell}, which does not report {m['moves']}")
    for cell in cells:
        e = [m for m in manifest["end_to_end"] if reports(m, cell)]
        if "setup_s" not in {m["name"] for m in e} or len(e) < 2:
            out.append(f"{cell} lacks setup_s or another end-to-end metric")
        if not any(reports(m, cell) for m in manifest["per_layer"]):
            out.append(f"{cell} has no per-layer metric")
    return out
