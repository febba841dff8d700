"""The traced run: ``torch.profiler`` over the window, and the reduction of
its events to what the per-layer readers and the ``breakdown`` need.

The window is the benchmark's own annotation ``bench.window``.  Device
activity is every kernel, copy and memset the profiler saw on the card; its
busy time is the union of their intervals inside the window (the arithmetic
of the port's ``chip_smoke.kernel_busy_share``, with copies and memsets
counted as busy too).  Idle time is named by what the host's main thread
was doing during it: the innermost benchmark span (``bench.*``) and the
innermost operator open at each instant.
"""

from __future__ import annotations

import contextlib
import re
from collections import defaultdict
from dataclasses import dataclass, field

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_KINDS = ("cuda_runtime", "cuda_driver")
WINDOW = "bench.window"
SPAN_PREFIX = "bench."


@contextlib.contextmanager
def span(name: str, on: bool):
    """A ``record_function`` annotation named ``name`` when ``on``; nothing
    at all otherwise, so the untraced run pays nothing."""
    if not on:
        yield
        return
    import torch

    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def profiled(cuda: bool):
    """The profiler with CPU (and CUDA) activity, no shapes, stacks or
    memory, over the block; yields a holder whose ``events`` is filled on
    exit.  It is started and stopped through ``torch.autograd``'s own calls,
    so that its millions of events are read as they come and never built
    into ``FunctionEvent`` objects, as ``torch.profiler.profile`` builds
    them on some versions."""
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.autograd import (ProfilerActivity, ProfilerConfig, ProfilerState,
                                _disable_profiler, _enable_profiler, _prepare_profiler)

    acts = {ProfilerActivity.CPU} | ({ProfilerActivity.CUDA} if cuda else set())
    args = (ProfilerState.KINETO, False, False, False, False, False, _ExperimentalConfig())
    try:
        config = ProfilerConfig(*args)
    except TypeError:  # versions that take a trace id too
        config = ProfilerConfig(*args, "")
    holder = _Holder()
    _prepare_profiler(config, acts)
    _enable_profiler(config, acts)
    try:
        yield holder
        if cuda:
            torch.cuda.synchronize()
    finally:
        events = _disable_profiler().events()
    holder.events = [
        (e.name(), kind(e), e.start_ns(), e.start_ns() + e.duration_ns(),
         e.correlation_id(), e.start_thread_id())
        for e in events
    ]


def kind(e) -> str:
    """The event's activity type as kineto names it; from its device and name
    where the profiler does not expose the type (PyTorch before 2.13)."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    name = e.name()
    note = e.is_user_annotation() if hasattr(e, "is_user_annotation") \
        else name.startswith(SPAN_PREFIX)
    if str(e.device_type()).endswith("CPU"):
        if note:
            return "user_annotation"
        if e.correlation_id() and name.startswith("cu"):
            return "cuda_runtime"
        return "cpu_op"
    if note:
        return "gpu_user_annotation"
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


@dataclass
class _Holder:
    events: list = field(default_factory=list)


def union_ns(intervals, lo: int, hi: int) -> int:
    """Length of the union of ``intervals`` (start, end) clipped to [lo, hi]."""
    total, end = 0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


def idle_gaps(intervals, lo: int, hi: int) -> list[tuple[int, int]]:
    """The stretches of [lo, hi] that no interval covers, in time order."""
    gaps, end = [], lo
    for a, b in sorted(intervals):
        if a > end and end < hi:
            gaps.append((end, min(a, hi)))
        end = max(end, b)
    if end < hi:
        gaps.append((end, hi))
    return gaps


class Trace:
    """Events of one traced window, as plain tuples
    ``(name, kind, start_ns, end_ns, correlation, thread)``."""

    def __init__(self, events):
        wins = [e for e in events if e[0] == WINDOW and e[1] == "user_annotation"]
        if len(wins) != 1:
            raise ValueError(f"expected one {WINDOW} annotation, found {len(wins)}")
        _, _, self.t0, self.t1, _, self.main_thread = wins[0]
        self.device = [e for e in events if e[1] in DEVICE_KINDS
                       and e[3] > self.t0 and e[2] < self.t1]
        self.host = [e for e in events if e[1] in ("cpu_op", "user_annotation")
                     and e[5] == self.main_thread]
        self.launches = [e for e in events if e[1] in LAUNCH_KINDS]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    def busy_s(self) -> float:
        return union_ns([(e[2], e[3]) for e in self.device], self.t0, self.t1) * 1e-9

    def device_s(self, pattern: str | None = None, kinds=DEVICE_KINDS) -> float:
        """Summed device seconds of events whose name matches ``pattern``."""
        rx = re.compile(pattern) if pattern else None
        return sum(_clip(e, self.t0, self.t1) for e in self.device
                   if e[1] in kinds and (rx is None or rx.search(e[0]))) * 1e-9

    def count(self, pattern: str, kinds=("kernel",)) -> int:
        rx = re.compile(pattern)
        return sum(1 for e in self.device if e[1] in kinds and rx.search(e[0]))

    def spans(self, name: str) -> list[tuple[int, int]]:
        """(start, end) of the main thread's annotations called ``name``
        inside the window."""
        return [(e[2], e[3]) for e in self.host if e[0] == name
                and e[1] == "user_annotation" and e[2] >= self.t0 and e[3] <= self.t1]

    def device_s_under(self, name: str) -> float:
        """Device seconds of the work launched while an annotation ``name``
        was open on the main thread (launches linked by correlation id)."""
        spans = sorted(self.spans(name))
        if not spans:
            return 0.0
        starts = [s for s, _ in spans]
        import bisect

        corr = set()
        for e in self.launches:
            if e[5] != self.main_thread:
                continue
            i = bisect.bisect_right(starts, e[2]) - 1
            if i >= 0 and e[2] < spans[i][1]:
                corr.add(e[4])
        return sum(e[3] - e[2] for e in self.device if e[4] in corr) * 1e-9

    def top_device_ops(self, k: int = 10) -> list[list]:
        by = defaultdict(int)
        for e in self.device:
            by[e[0]] += _clip(e, self.t0, self.t1)
        return [[n, t * 1e-9] for n, t in sorted(by.items(), key=lambda x: -x[1])[:k]]

    def idle_by_host(self, k: int = 10) -> list[list]:
        """Idle seconds of the window summed by what the host's main thread
        was doing during them, the ``k`` largest."""
        gaps = idle_gaps([(e[2], e[3]) for e in self.device], self.t0, self.t1)
        by = defaultdict(int)
        segs = host_timeline(self.host, self.t0, self.t1)
        i = 0
        for g0, g1 in gaps:
            while i < len(segs) and segs[i][1] <= g0:
                i += 1
            j = i
            while j < len(segs) and segs[j][0] < g1:
                a, b, name = segs[j]
                by[name] += min(b, g1) - max(a, g0)
                j += 1
        return [[n, t * 1e-9] for n, t in sorted(by.items(), key=lambda x: -x[1])[:k]]


def host_timeline(host, lo: int, hi: int) -> list[tuple[int, int, str]]:
    """[lo, hi] cut into (start, end, name) segments by what the host's
    thread was inside: nested events, each segment named after the
    innermost benchmark span and the innermost operator open in it."""
    segs: list = []
    stack: list = []
    cur = lo

    def emit(end):
        nonlocal cur
        a, b = max(cur, lo), min(end, hi)
        if b > a:
            segs.append((a, b, _host_name(stack)))
        cur = max(cur, end)

    for e in sorted(host, key=lambda e: (e[2], -e[3])):
        while stack and stack[-1][3] <= e[2]:
            emit(stack[-1][3])
            stack.pop()
        emit(e[2])
        stack.append(e)
    while stack:
        emit(stack[-1][3])
        stack.pop()
    emit(hi)
    return segs


def _clip(e, lo: int, hi: int) -> int:
    return max(0, min(e[3], hi) - max(e[2], lo))


def _host_name(stack) -> str:
    bench = next((e[0] for e in reversed(stack)
                  if e[1] == "user_annotation" and e[0].startswith(SPAN_PREFIX)
                  and e[0] != WINDOW), None)
    op = next((e[0] for e in reversed(stack) if e[1] == "cpu_op"), None)
    parts = [p for p in (bench, op) if p]
    return " > ".join(parts) if parts else "outside any operator"
