"""The matching stage's similarity operations over the window as a share of
the card's fp32 peak (``pipeline/match.py``, the whole job): 2 * K1 * K2 * D
a pair, times the pairs matched in the window, whatever kernels did the
work."""

from benchmark.roofline import counts


def read(ctx):
    n = ctx.counters
    if not n.get("pairs"):
        return None
    k = n["keypoints"]
    flops = counts.match_flops(n["pairs"], k, k, n["dim"])
    return 100.0 * flops / ctx.trace.window_s / counts.peak_flops("fp32")
