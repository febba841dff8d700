"""The reduction of a trace: busy union, idle gaps, the host's timeline,
and the readers' queries, on synthetic events."""

import pytest

from benchmark.harness import trace as tr


def test_union_clips_and_merges_overlaps():
    iv = [(0, 10), (5, 15), (20, 30), (28, 40), (50, 60)]
    assert tr.union_ns(iv, 0, 100) == 15 + 20 + 10
    assert tr.union_ns(iv, 8, 25) == 7 + 5
    assert tr.union_ns([], 0, 100) == 0


def test_idle_gaps_are_the_complement():
    iv = [(10, 20), (15, 30), (40, 50)]
    assert tr.idle_gaps(iv, 0, 60) == [(0, 10), (30, 40), (50, 60)]
    busy = tr.union_ns(iv, 0, 60)
    assert busy + sum(b - a for a, b in tr.idle_gaps(iv, 0, 60)) == 60


def _events():
    # (name, kind, start, end, correlation, thread); main thread 1.
    return [
        ("bench.window", "user_annotation", 0, 1000, 0, 1),
        ("bench.batch", "user_annotation", 0, 500, 0, 1),
        ("aten::copy_", "cpu_op", 10, 100, 0, 1),
        ("bench.detect", "user_annotation", 300, 450, 0, 1),
        ("aten::add", "cpu_op", 310, 320, 0, 1),
        ("cudaLaunchKernel", "cuda_runtime", 312, 315, 7, 1),
        ("cudaLaunchKernel", "cuda_runtime", 200, 205, 8, 1),
        ("bench.batch", "user_annotation", 500, 1000, 0, 1),
        ("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 50, 100, 9, 0),
        ("attention_kernel", "kernel", 150, 400, 8, 0),
        ("add_kernel", "kernel", 400, 420, 7, 0),
        ("bench.batch", "gpu_user_annotation", 0, 500, 0, 0),
        ("outside", "kernel", 2000, 3000, 0, 0),
    ]


def test_trace_queries():
    t = tr.Trace(_events())
    assert t.window_s == pytest.approx(1e-6)
    assert t.busy_s() == pytest.approx((50 + 250 + 20) * 1e-9)
    assert t.device_s(r"\battention_kernel\b", kinds=("kernel",)) == pytest.approx(250e-9)
    assert t.count("HtoD", kinds=("gpu_memcpy",)) == 1
    assert t.spans("bench.batch") == [(0, 500), (500, 1000)]
    # Only the add kernel was launched inside bench.detect.
    assert t.device_s_under("bench.detect") == pytest.approx(20e-9)
    ops = dict((n, s) for n, s in t.top_device_ops())
    assert set(ops) == {"attention_kernel", "Memcpy HtoD (Pageable -> Device)", "add_kernel"}


def test_idle_is_named_by_the_host_throughout():
    t = tr.Trace(_events())
    idle = dict(t.idle_by_host())
    # Idle stretches: 0-50, 100-150, 420-1000 (the device line has no work
    # after 420 inside the window).
    assert sum(idle.values()) == pytest.approx((50 + 50 + 580) * 1e-9)
    assert idle["bench.batch > aten::copy_"] == pytest.approx(40e-9)  # 10-50
    assert idle["bench.detect"] == pytest.approx(30e-9)  # 420-450
    assert idle["bench.batch"] == pytest.approx((10 + 50 + 50 + 500) * 1e-9)


def test_host_timeline_covers_the_window_once():
    host = [e for e in _events() if e[1] in ("cpu_op", "user_annotation") and e[5] == 1]
    segs = tr.host_timeline(host, 0, 1000)
    assert segs[0][0] == 0 and segs[-1][1] == 1000
    assert all(a[1] == b[0] for a, b in zip(segs, segs[1:]))
    assert ("bench.detect > aten::add" in {s[2] for s in segs})


def test_kind_from_name_and_device_where_no_activity_type():
    class Old:
        def __init__(self, name, device, corr=0):
            self._n, self._d, self._c = name, device, corr

        def name(self):
            return self._n

        def device_type(self):
            return f"DeviceType.{self._d}"

        def correlation_id(self):
            return self._c

    assert tr.kind(Old("bench.batch", "CPU")) == "user_annotation"
    assert tr.kind(Old("aten::mm", "CPU")) == "cpu_op"
    assert tr.kind(Old("cudaLaunchKernel", "CPU", 4)) == "cuda_runtime"
    assert tr.kind(Old("Memcpy DtoH (Device -> Pageable)", "CUDA")) == "gpu_memcpy"
    assert tr.kind(Old("Memset (Device)", "CUDA")) == "gpu_memset"
    assert tr.kind(Old("bench.batch", "CUDA")) == "gpu_user_annotation"
    assert tr.kind(Old("nvjet_tst_256x152", "CUDA")) == "kernel"
