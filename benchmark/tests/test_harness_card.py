"""On the card: each cell at its own size, once as the program runs it and
once with its control in the program's place (the port's int8 backbone for
extraction; the reference matcher in TF32 for matching).  The first must
come out correct and the second not; so must an extract cell whose
refinement is skipped.  Skipped without a CUDA card:

    python -m pytest benchmark/tests/test_harness_card.py -m gpu
"""

import time

import pytest
from test_harness_faults import broken_refinement

from benchmark.harness import manifest

CONTROLS = {"vitb14.extract": "int8", "vitl14.extract": "int8", "vitb14.match": "tf32"}


@pytest.mark.gpu
@pytest.mark.parametrize("workload", sorted(CONTROLS))
def test_sound_run_passes_and_control_fails(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from benchmark.harness.runner import run_cell

    results = {}
    for variant in (None, CONTROLS[workload]):
        cell = manifest.resolve(manifest.load(), workload)
        results[variant] = run_cell(cell, 424242, 4.0, False, "cuda", time.perf_counter(),
                                    variant)
    assert results[None]["correct"], results[None]["checks"]
    assert not results[CONTROLS[workload]]["correct"], results[CONTROLS[workload]]["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["vitb14.extract", "vitl14.extract"])
def test_skipped_refinement_fails(workload, monkeypatch):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from benchmark.harness.runner import run_cell

    broken_refinement(monkeypatch, "skipped")
    cell = manifest.resolve(manifest.load(), workload)
    r = run_cell(cell, 434343, 4.0, False, "cuda", time.perf_counter())
    assert not r["correct"], r["checks"]
