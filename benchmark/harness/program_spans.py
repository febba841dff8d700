"""The program's own spans in a traced window: the ``vc.*`` annotations
that the port opens at its phase boundaries (``utils/profiling.span``),
read from the main thread of a :class:`~benchmark.harness.trace.Trace`.

A span set is the union of the intervals of one or more span names, so
phases that repeat or overlap count once.  Against it this module reads the
device's idle time (the window's gaps in kernels, copies and memsets, as
``Trace.busy_s`` has them), the host's time, and the CUDA runtime calls
that make the host wait for the device.  A program that opens no such span
gives empty sets, and the readers built on them return nothing.
"""

from __future__ import annotations

from benchmark.harness.trace import idle_gaps

PREFIX = "vc."
# Runtime calls that return only once the device has caught up (a plain
# cudaMemcpy* without Async waits for its copy too).
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def is_sync(name: str) -> bool:
    return name in SYNCS or (name.startswith("cudaMemcpy") and "Async" not in name)


def merge(intervals) -> list[tuple[int, int]]:
    """Sorted, disjoint intervals covering the same points as ``intervals``."""
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def overlap_ns(xs, ys) -> int:
    """Length of the intersection of two sorted, disjoint interval lists."""
    total = i = j = 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def spans(trace, names) -> list[tuple[int, int]]:
    """The union of the main thread's ``vc.*`` events named in ``names``,
    clipped to the window.  An event counts whether the profiler typed it
    ``user_annotation`` or ``cpu_op``: ``Trace.host`` holds both."""
    names = {names} if isinstance(names, str) else set(names)
    return merge((max(e[2], trace.t0), min(e[3], trace.t1)) for e in trace.host
                 if e[0].startswith(PREFIX) and e[0] in names)


def idle(trace) -> list[tuple[int, int]]:
    """The window's stretches with no kernel, copy or memset on the card."""
    return idle_gaps([(e[2], e[3]) for e in trace.device], trace.t0, trace.t1)


def idle_ns(trace, names=None) -> int:
    """Device-idle ns of the window under the span set ``names`` (all of
    the window's idle time where ``names`` is None)."""
    gaps = idle(trace)
    if names is None:
        return sum(b - a for a, b in gaps)
    return overlap_ns(gaps, spans(trace, names))


def host_ns(trace, names) -> int:
    """Host ns of the main thread under the span set ``names``."""
    return sum(b - a for a, b in spans(trace, names))


def syncs(trace, names) -> int:
    """Synchronizing runtime calls that the main thread started inside the
    span set ``names``."""
    import bisect

    covered = spans(trace, names)
    starts = [a for a, _ in covered]
    n = 0
    for e in trace.launches:
        if e[5] != trace.main_thread or not is_sync(e[0]):
            continue
        i = bisect.bisect_right(starts, e[2]) - 1
        if i >= 0 and e[2] < covered[i][1]:
            n += 1
    return n


def per(trace, counters: dict, unit: str, names, value) -> float | None:
    """``value(trace, names)`` over ``counters[unit]`` (batches or jobs);
    None where the window has no such unit or no span of ``names``."""
    n = counters.get(unit, 0)
    if not n or not spans(trace, names):
        return None
    return value(trace, names) / n
