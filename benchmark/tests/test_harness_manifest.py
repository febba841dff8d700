"""BENCHMARK.json against the contract, and the harness finding every file
by name, so that a cell, a mix or a metric is added with files alone."""

import json
import shutil

import pytest

from benchmark.harness import manifest


def test_the_manifest_has_no_problem():
    assert manifest.problems(manifest.load()) == []


def test_every_cell_resolves_to_its_files():
    m = manifest.load()
    for w in m["workloads"]:
        cell = manifest.resolve(m, w["name"])
        assert manifest.driver_path(cell.driver).is_file()
        assert {x["name"] for x in cell.end_to_end} >= {"setup_s"}
        assert cell.limits and manifest.limits_path(w["name"]).is_file()
        for metric in cell.per_layer:
            assert manifest.metric_path(metric["name"]).is_file()
            moves = [e for e in cell.end_to_end if e["name"] == metric["moves"]]
            assert moves, (w["name"], metric["name"])


@pytest.mark.parametrize("name,ok", [
    ("vitb14.extract", True), ("device_idle_pct.match", True), ("_x-1", True),
    ("a b", False), ("a,b", False), ("a/b", False), ("é", False), ("x" * 65, False),
])
def test_names(name, ok):
    assert bool(manifest.NAME_RE.match(name)) is ok


@pytest.mark.parametrize("unit,ok", [
    ("img/s", True), ("%", True), ("pairs/s", True), ("ms", True),
    ("tokens per s", False), ("µs", False), ("x" * 17, False),
])
def test_units(unit, ok):
    assert bool(manifest.UNIT_RE.match(unit)) is ok


def test_problems_are_found():
    m = manifest.load()
    m["per_layer"][0]["moves"] = "match_pairs_per_s"  # a cell that does not report it
    m["workloads"].append(dict(m["workloads"][0]))  # a cell twice
    m["end_to_end"][0]["bound"] = 0.5
    found = " | ".join(manifest.problems(m))
    assert "does not report" in found and "twice" in found and "bound" in found


def test_a_new_metric_is_found_by_name(tmp_path, monkeypatch):
    """A throwaway per-layer metric added as a file and an entry, nothing
    else edited: the harness resolves, checks and reads it."""
    bench = tmp_path / "benchmark"
    shutil.copytree(manifest.BENCH_DIR, bench, ignore=shutil.ignore_patterns("__pycache__"))
    (bench / "metrics" / "throwaway_batches.extract.py").write_text(
        "def read(ctx):\n    return float(ctx.counters['batches'])\n")
    m = manifest.load()
    m["per_layer"].append({"name": "throwaway_batches.extract", "unit": "count",
                           "better": "higher", "source": "program_counter", "layer": "device",
                           "moves": "extract_img_per_s", "workloads": ["vitb14.extract"]})
    monkeypatch.setattr(manifest, "BENCH_DIR", bench)
    assert manifest.problems(m) == []
    cell = manifest.resolve(m, "vitb14.extract")
    assert "throwaway_batches.extract" in [x["name"] for x in cell.per_layer]
    reader = manifest.load_file_module(manifest.metric_path("throwaway_batches.extract"), "t")

    class Ctx:
        counters = {"batches": 7}

    assert reader.read(Ctx) == 7.0
    assert "throwaway" not in json.dumps(manifest.load())


def test_a_metric_split_by_cells_is_read_as_its_quantity():
    path = manifest.metric_path("attn_kernel_roofline_pct.vitl14")
    assert path.name == "attn_kernel_roofline_pct.py"
    assert manifest.metric_path("device_idle_pct.extract.vitl14").name == \
        "device_idle_pct.extract.py"
    assert manifest.quantities("a.b.c") == ["a.b.c", "a.b", "a"]
    assert manifest.value_of("extract_img_per_s.vitl14", {"extract_img_per_s": 3.0}) == 3.0
    with pytest.raises(KeyError):
        manifest.value_of("match_pairs_per_s", {"extract_img_per_s": 3.0})


def test_limits_are_checked_against_the_driver(tmp_path, monkeypatch):
    """A cell's limits file must exist and limit only numbers its driver
    reads."""
    bench = tmp_path / "benchmark"
    shutil.copytree(manifest.BENCH_DIR, bench, ignore=shutil.ignore_patterns("__pycache__"))
    monkeypatch.setattr(manifest, "BENCH_DIR", bench)
    m = manifest.load()
    (bench / "limits" / "vitb14.match.json").unlink()
    (bench / "limits" / "vitl14.extract.json").write_text('{"rows_differ": 1e-4}')
    found = " | ".join(manifest.problems(m))
    assert "limits file vitb14.match.json missing" in found
    assert "vitl14.extract limits rows_differ" in found
