"""Whole runs on the CPU, past the harness's look for a card, with the timed
path broken underneath: each fault that a cell can have must turn
``correct`` false, and the unbroken run must come out true.

The port runs in float32 here (its plain versions on CPU tensors), so the
unbroken run agrees with the reference to rounding and every limit holds;
at the cells' sizes the limits were set from runs on the card."""

import numpy as np
import pytest
import torch
from conftest import run_tiny


def test_extract_unbroken_is_correct(tiny_cell):
    r = run_tiny(tiny_cell("vitb14.extract"))
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0


@pytest.mark.parametrize("workload,part", [("vitb14.extract", ""),
                                           ("vitl14.extract", ".vitl14")])
def test_extract_trace_reads_its_metrics(tiny_cell, workload, part):
    r = run_tiny(tiny_cell(workload), trace=True)
    assert r["correct"]
    assert {"extract_mfu_pct" + part, "device_idle_pct.extract" + part} <= set(r["metrics"])
    assert r["device"]["window_s"] > 0 and "breakdown" in r
    assert "extract_img_per_s" + part not in r["metrics"]


def test_extract_untraced_reports_its_cells_metrics(tiny_cell):
    r = run_tiny(tiny_cell("vitl14.extract"))
    assert set(r["metrics"]) == {"extract_img_per_s.vitl14", "extract_batch_ms_p95.vitl14",
                                 "setup_s"}
    assert r["metrics"]["extract_img_per_s.vitl14"]["value"] > 0


def _broken_extract(monkeypatch, how):
    from vit_colmap_tpu_torch.features.vit_extractor import ViTExtractor

    orig = ViTExtractor.extract_batch
    last = {}

    def broken(self, images):
        out = [np.array(t, copy=True) for t in orig(self, images)]
        if how == "half_batch":  # the second half left out, the first copied over it
            for t in out:
                t[len(t) // 2:] = t[: len(t) - len(t) // 2]
        elif how == "altered":  # one answer altered where it is produced
            out[3][0, 0] = 255 - out[3][0, 0]
        elif how == "stale":  # the previous batch's answer returned unchanged
            prev, last["out"] = last.get("out"), out
            if prev is not None:
                return tuple(prev)
        return tuple(out)

    monkeypatch.setattr(ViTExtractor, "extract_batch", broken)


@pytest.mark.parametrize("how", ["half_batch", "altered", "stale"])
def test_extract_faults_are_not_correct(tiny_cell, monkeypatch, how):
    _broken_extract(monkeypatch, how)
    r = run_tiny(tiny_cell("vitb14.extract"), seconds=1.0)
    assert not r["correct"], r["checks"]


def broken_refinement(monkeypatch, how):
    """Refinement skipped (offsets of 0), or computed wrongly inside its
    clamp (the offsets mirrored), where the extractor calls it."""
    from vit_colmap_tpu_torch.features import vit_extractor

    orig = vit_extractor.quadratic_refine
    scale = {"skipped": 0.0, "mirrored": -1.0}[how]
    monkeypatch.setattr(vit_extractor, "quadratic_refine",
                        lambda scores, xy: scale * orig(scores, xy))


@pytest.mark.parametrize("workload", ["vitb14.extract", "vitl14.extract"])
@pytest.mark.parametrize("how", ["skipped", "mirrored"])
def test_extract_refinement_faults_are_not_correct(tiny_cell, monkeypatch, workload, how):
    broken_refinement(monkeypatch, how)
    r = run_tiny(tiny_cell(workload), seconds=1.0)
    assert not r["correct"], r["checks"]
    if how == "skipped":  # caught by the refined positions, not by the count
        assert r["checks"]["kp_miss"]["value"] <= r["checks"]["kp_miss"]["limit"]


def test_extract_fault_in_vitl14_limits(tiny_cell, monkeypatch):
    _broken_extract(monkeypatch, "altered")
    r = run_tiny(tiny_cell("vitl14.extract"), seconds=1.0)
    assert not r["correct"], r["checks"]


def test_match_unbroken_is_correct(tiny_cell):
    r = run_tiny(tiny_cell("vitb14.match"))
    assert r["correct"], r["checks"]


def test_match_trace_reads_its_metrics(tiny_cell):
    r = run_tiny(tiny_cell("vitb14.match"), trace=True)
    assert r["correct"]
    assert {"match_mfu_pct", "db_write_ms_per_job"} <= set(r["metrics"])


@pytest.mark.parametrize("how", ["half_batch", "altered", "unchanged"])
def test_match_faults_are_not_correct(tiny_cell, monkeypatch, how):
    from vit_colmap_tpu_torch.pipeline import match as pm

    if how == "unchanged":  # a job that leaves the database as it found it
        monkeypatch.setattr(pm, "match_exhaustive",
                            lambda *a, **k: pm.MatchStats(num_pairs=15))
    else:
        orig = pm.get_pair_matcher

        def broken_matcher(*a):
            matcher = orig(*a)

            def run(d1, d2, v1, v2, *rest):
                out = matcher(d1, d2, v1, v2, *rest).clone()
                if how == "half_batch":  # half of each batch of pairs left out
                    out[out.shape[0] // 2:] = -1
                else:  # one match of the batch altered where it is produced
                    hit = torch.nonzero(out >= 0)
                    if len(hit):
                        p, row = (int(x) for x in hit[0])
                        out[p, row] = (out[p, row] + 1) % out.shape[1]
                return out

            return run

        monkeypatch.setattr(pm, "get_pair_matcher", broken_matcher)
    r = run_tiny(tiny_cell("vitb14.match"), seconds=1.0)
    assert not r["correct"], r["checks"]


def test_match_control_in_the_programs_place_is_not_correct(tiny_cell):
    r = run_tiny(tiny_cell("vitb14.match"), variant="bf16")
    assert not r["correct"], r["checks"]
