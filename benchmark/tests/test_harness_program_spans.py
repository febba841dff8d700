"""The program's ``vc.*`` spans in a trace (``harness/program_spans.py``)
and the readers built on them, on synthetic events."""

import types

import pytest

from benchmark.harness import manifest
from benchmark.harness import program_spans as ps
from benchmark.harness import trace as tr


def _events():
    # (name, kind, start, end, correlation, thread); main thread 1.  The
    # device is busy 100-200, 250-300 and 600-700 of the window 0-1000.
    return [
        ("bench.window", "user_annotation", 0, 1000, 0, 1),
        ("bench.batch", "user_annotation", 0, 500, 0, 1),
        ("vc.extract.batch", "user_annotation", 0, 450, 0, 1),
        ("vc.extract.wire", "user_annotation", 10, 80, 0, 1),
        ("vc.extract.h2d", "user_annotation", 60, 150, 0, 1),  # overlaps wire
        ("vc.extract.forward", "user_annotation", 150, 300, 0, 1),
        ("vc.extract.readback", "cpu_op", 320, 440, 0, 1),  # typed as an op
        ("aten::copy_", "cpu_op", 330, 400, 0, 1),
        ("vc.extract.wire", "user_annotation", 500, 900, 0, 2),  # another thread
        ("vc.extract.batch", "user_annotation", 950, 1200, 0, 1),  # past the window
        ("cudaStreamSynchronize", "cuda_runtime", 100, 140, 11, 1),
        ("cudaMemcpy", "cuda_runtime", 340, 350, 12, 1),
        ("cudaMemcpyAsync", "cuda_runtime", 335, 338, 13, 1),  # does not wait
        ("cudaStreamSynchronize", "cuda_runtime", 360, 400, 14, 2),  # another thread
        ("cudaDeviceSynchronize", "cuda_runtime", 470, 480, 15, 1),  # outside the spans
        ("cudaEventSynchronize", "cuda_runtime", 1100, 1110, 16, 1),  # past the window
        ("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 100, 200, 11, 0),
        ("attention_kernel", "kernel", 250, 300, 17, 0),
        ("add_kernel", "kernel", 600, 700, 18, 0),
    ]


def _trace(events=None):
    return tr.Trace(events or _events())


def test_merge_and_overlap():
    assert ps.merge([(5, 9), (0, 3), (2, 4), (9, 12), (20, 20)]) == [(0, 4), (5, 12)]
    assert ps.overlap_ns([(0, 10), (20, 30)], [(5, 25)]) == 5 + 5
    assert ps.overlap_ns([], [(0, 5)]) == 0


def test_idle_under_overlapping_spans_is_counted_once():
    t = _trace()
    # wire 10-80 and h2d 60-150 as one set 10-150; the device is idle 0-100.
    assert ps.spans(t, ("vc.extract.wire", "vc.extract.h2d")) == [(10, 150)]
    assert ps.idle_ns(t, ("vc.extract.wire", "vc.extract.h2d")) == 90
    assert ps.host_ns(t, ("vc.extract.wire", "vc.extract.h2d")) == 140


def test_a_span_on_another_thread_is_ignored():
    t = _trace()
    # Thread 2's wire span covers 500-900 (idle there 500-600, 700-900), but
    # only the main thread's own phases count.
    assert ps.idle_ns(t, "vc.extract.wire") == 70  # 10-80 only
    assert ps.syncs(t, "vc.extract.readback") == 1  # thread 2's call is not counted


def test_syncs_outside_the_span_or_window_are_not_counted():
    t = _trace()
    # Inside vc.extract.batch (0-450, and 950-1000 clipped): the stream
    # synchronization at 100 and the plain cudaMemcpy at 340; not the
    # Async copy, not the device sync at 470, not the event sync at 1100.
    assert ps.syncs(t, "vc.extract.batch") == 2
    assert ps.is_sync("cudaMemcpy2D") and not ps.is_sync("cudaMemcpy2DAsync")
    assert not ps.is_sync("cudaLaunchKernel")


def test_a_span_typed_as_an_op_is_found():
    t = _trace()
    assert ps.spans(t, "vc.extract.readback") == [(320, 440)]
    assert ps.idle_ns(t, "vc.extract.readback") == 120  # no device work 300-600


def test_phase_idle_plus_idle_outside_is_the_idle_of_the_window():
    t = _trace()
    phases = ("vc.extract.wire", "vc.extract.h2d", "vc.extract.forward",
              "vc.extract.readback")
    under = sum(ps.idle_ns(t, p) for p in (phases[:2], phases[2:3], phases[3:]))
    outside = ps.overlap_ns(ps.idle(t), _complement(ps.spans(t, phases), t.t0, t.t1))
    window_idle_ns = round((t.window_s - t.busy_s()) * 1e9)
    assert under + outside == ps.idle_ns(t) == window_idle_ns


def _complement(intervals, lo, hi):
    out, end = [], lo
    for a, b in intervals:
        if a > end:
            out.append((end, a))
        end = max(end, b)
    if end < hi:
        out.append((end, hi))
    return out


def _ctx(events, counters):
    return types.SimpleNamespace(trace=tr.Trace(events), counters=counters, config={},
                                 traffic={})


def _read(name, ctx):
    return manifest.load_file_module(manifest.metric_path(name), "metric").read(ctx)


def test_extract_readers():
    ctx = _ctx(_events(), {"batches": 2, "images": 4})
    assert _read("extract_wire_idle_ms_per_batch", ctx) == pytest.approx(90e-6 / 2)
    assert _read("extract_wire_idle_ms_per_batch.vitl14", ctx) == pytest.approx(90e-6 / 2)
    assert _read("extract_readback_idle_ms_per_batch", ctx) == pytest.approx(120e-6 / 2)
    assert _read("extract_host_syncs_per_batch", ctx) == 1.0


def test_match_readers():
    ev = [("bench.window", "user_annotation", 0, 1000, 0, 1),
          ("vc.match.job", "user_annotation", 0, 900, 0, 1),
          ("vc.match.read", "user_annotation", 0, 100, 0, 1),
          ("vc.match.assemble", "user_annotation", 100, 200, 0, 1),
          ("vc.match.launch", "user_annotation", 200, 500, 0, 1),
          ("vc.match.unpack", "user_annotation", 500, 800, 0, 1),
          ("vc.match.write", "user_annotation", 800, 900, 0, 1),
          ("cudaLaunchKernel", "cuda_runtime", 210, 220, 5, 1),
          ("cudaStreamSynchronize", "cuda_runtime", 510, 600, 6, 1),
          ("cudaStreamSynchronize", "cuda_runtime", 610, 700, 7, 1),
          ("match_topk2_kernel", "kernel", 150, 600, 5, 0)]
    ctx = _ctx(ev, {"jobs": 1, "pairs": 2016})
    assert _read("match_prep_idle_ms_per_job", ctx) == pytest.approx(150e-6)
    assert _read("match_launch_idle_ms_per_job", ctx) == 0.0
    assert _read("match_unpack_idle_ms_per_job", ctx) == pytest.approx(200e-6)
    assert _read("match_host_syncs_per_job", ctx) == 2.0


@pytest.mark.parametrize("name", [
    "extract_wire_idle_ms_per_batch", "extract_readback_idle_ms_per_batch",
    "extract_host_syncs_per_batch", "match_prep_idle_ms_per_job",
    "match_launch_idle_ms_per_job", "match_unpack_idle_ms_per_job",
    "match_host_syncs_per_job"])
def test_a_program_without_spans_reads_nothing(name):
    """The parent of the spans' change has none: each reader returns None
    and does not raise."""
    ev = [e for e in _events() if not e[0].startswith("vc.")]
    assert _read(name, _ctx(ev, {"batches": 3, "images": 6, "jobs": 3})) is None
    assert _read(name, _ctx(_events(), {})) is None
