"""Arithmetic of the end-to-end metrics and of the spread between runs."""

from __future__ import annotations

import math
import statistics
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0..100) of all ``values``, interpolated
    linearly between the two nearest ranks (numpy's default rule)."""
    if not values:
        raise ValueError("percentile of no values")
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile {q} outside 0..100")
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def window_rate(units: float, start_s: float, end_s: float) -> float:
    """Work per second over a whole window: every unit completed inside it
    over all of its length."""
    if end_s <= start_s:
        raise ValueError("a window must have a positive length")
    return units / (end_s - start_s)


def quartile_spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartiles as a share of the
    median, with ``statistics.quantiles(values, n=4)``."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def trimmed(values: Sequence[float]) -> list[float]:
    """``values`` without the one farthest from their median."""
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return [v for i, v in enumerate(values) if i != far]
