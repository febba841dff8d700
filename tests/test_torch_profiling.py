"""``utils/profiling.py`` of the port against the JAX package's: the stage
timer's totals, counts, ``summary()`` text and ``to_dict()`` equal on the
same recorded stages, and ``trace`` writing a ``torch.profiler`` Chrome trace
on the CPU."""

import json

import pytest

from vit_colmap_tpu.utils import profiling as jprof
from vit_colmap_tpu_torch.utils import profiling as tprof

STAGES = [("extract", 1.25), ("match+verify", 0.5), ("extract", 0.75),
          ("reconstruction", 3.0), ("match+verify", 0.125)]


def _timers():
    j, t = jprof.StageTimer(), tprof.StageTimer()
    for name, seconds in STAGES:
        j.record(name, seconds)
        t.record(name, seconds)
    return j, t


def test_stage_timer_matches_jax(tmp_path):
    j, t = _timers()
    assert dict(t.totals) == dict(j.totals) == {
        "extract": 2.0, "match+verify": 0.625, "reconstruction": 3.0}
    assert dict(t.counts) == dict(j.counts)
    assert t.summary() == j.summary()
    assert t.summary().splitlines()[1].split()[0] == "reconstruction"
    assert t.to_dict() == j.to_dict()
    t.export_json(tmp_path / "a" / "t.json")
    j.export_json(tmp_path / "b" / "j.json")
    assert (tmp_path / "a" / "t.json").read_text() == (tmp_path / "b" / "j.json").read_text()


def test_stage_context_records_once_even_on_error():
    t = tprof.StageTimer()
    with pytest.raises(RuntimeError):
        with t.stage("extract"):
            raise RuntimeError("stage failed")
    with t.stage("extract"):
        pass
    assert t.counts["extract"] == 2 and t.totals["extract"] >= 0.0


def test_profile_dir_reads_the_environment(monkeypatch):
    monkeypatch.delenv("VIT_COLMAP_PROFILE_DIR", raising=False)
    assert tprof.profile_dir() is None is jprof.profile_dir()
    monkeypatch.setenv("VIT_COLMAP_PROFILE_DIR", "/somewhere")
    assert tprof.profile_dir() == "/somewhere" == jprof.profile_dir()


def test_trace_writes_a_chrome_trace(tmp_path, monkeypatch):
    import torch

    monkeypatch.delenv("VIT_COLMAP_PROFILE_DIR", raising=False)
    with tprof.trace():  # no directory: nothing is written
        torch.ones(4).sum()
    monkeypatch.setenv("VIT_COLMAP_PROFILE_DIR", str(tmp_path / "prof"))
    with tprof.trace():
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    traces = list((tmp_path / "prof").glob("trace_*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
