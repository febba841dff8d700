"""Stage timers and profiler traces.

Counterpart of ``vit_colmap_tpu/utils/profiling.py``:

* :class:`StageTimer`: named wall-clock counters (count, total seconds)
  that the pipeline's stages report into, printed as a table
  (``summary()``) and exported as JSON;
* :func:`trace`: ``torch.profiler`` over a block (host and CUDA activity),
  written as a Chrome trace into the directory given, or into
  ``VIT_COLMAP_PROFILE_DIR`` (``--profile-dir`` on the pipeline CLI); a
  no-op when neither is set;
* :func:`relay_epoch_probe`: the round trip of a trivial launch on the
  card, the link's health beside a measurement;
* :class:`span`: a named phase of the program (``vc.*``) on the profiler's
  own clock, recorded only while a ``torch.profiler`` session records.
"""

from __future__ import annotations

import contextlib
import functools
import json
import logging
import os
import time
from collections import defaultdict
from pathlib import Path
from typing import Callable, Iterator, Optional, Union

import torch

logger = logging.getLogger(__name__)

# One C call (about 0.1 us); ``record_function`` itself costs about 10 us
# even with no profiler, so it is never entered unless one records.
_profiler_enabled = torch._C._autograd._profiler_enabled
# Under a profiler ``record_function`` costs about 14 us a span, which
# lands in the very gaps the spans measure; the C++ annotation costs about
# 1.5 us (its events are typed ``cpu_op``, not ``user_annotation``).
_annotation = getattr(torch._C._profiler, "_RecordFunctionFast", None) \
    or torch.profiler.record_function


class span:
    """``with span("vc.match.read"):`` -- a profiler annotation named
    ``name`` over the block while a profiler records (so it shares
    the device trace's clock with the kernels and copies it launched);
    otherwise one check and nothing else.  As a decorator,
    ``@span("vc.extract.detect")``, each call opens a span of its own."""

    __slots__ = ("name", "_rec")

    def __init__(self, name: str) -> None:
        self.name = name
        self._rec = None

    def __enter__(self) -> "span":
        if _profiler_enabled():
            self._rec = _annotation(self.name)
            self._rec.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self._rec is not None:
            rec, self._rec = self._rec, None
            rec.__exit__(*exc)

    def __call__(self, fn: Callable) -> Callable:
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return spanned


def relay_epoch_probe(reps: int = 5) -> float:
    """Milliseconds, the least of ``reps``, of one trivial launch on the
    current CUDA device and ``torch.cuda.synchronize()``."""
    tiny = torch.zeros((), device="cuda")
    torch.cuda.synchronize()
    rt = []
    for _ in range(reps + 1):  # the first warms the launch path
        t0 = time.perf_counter()
        tiny.add_(1)
        torch.cuda.synchronize()
        rt.append(time.perf_counter() - t0)
    return min(rt[1:]) * 1e3


class StageTimer:
    """Accumulates (count, total seconds) per named stage."""

    def __init__(self) -> None:
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        """Times the block into ``name``; under a profiler it is also the
        span ``vc.stage.<name>``."""
        with span(f"vc.stage.{name}"):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.record(name, time.perf_counter() - t0)

    def record(self, name: str, seconds: float) -> None:
        self.totals[name] += seconds
        self.counts[name] += 1

    def summary(self) -> str:
        lines = ["Stage timings:"]
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            lines.append(
                f"  {name:<32} {self.totals[name]:8.3f}s"
                f"  ({self.counts[name]} calls)"
            )
        return "\n".join(lines)

    def to_dict(self) -> dict:
        return {
            name: {"seconds": self.totals[name], "calls": self.counts[name]}
            for name in self.totals
        }

    def export_json(self, path: Union[Path, str]) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)


# The timer the pipeline's stages report into.
GLOBAL_TIMER = StageTimer()


def profile_dir() -> Optional[str]:
    return os.environ.get("VIT_COLMAP_PROFILE_DIR") or None


@contextlib.contextmanager
def trace(trace_dir: Optional[str] = None) -> Iterator[None]:
    """``torch.profiler`` over the block, its Chrome trace written to
    ``<dir>/trace_<pid>_<ns>.json``, when a directory is given or set;
    otherwise nothing."""
    trace_dir = trace_dir or profile_dir()
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    Path(trace_dir).mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    path = Path(trace_dir) / f"trace_{os.getpid()}_{time.time_ns()}.json"
    prof.export_chrome_trace(str(path))
    logger.info("Wrote a torch.profiler trace to %s", path)
