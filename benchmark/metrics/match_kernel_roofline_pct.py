"""Kernel 2's share of its roofline (``csrc/match_topk2.cu``,
``kernels/match.py``): the least time of the window's jobs over the
kernel's device time.  A pair's least time is 2 * K1 * K2 * D operations
over the fp32 peak (the precision the configuration states for
similarities), or its bytes over the memory's rate where that is larger."""

from benchmark.roofline import counts

KERNEL = r"match_topk2_kernel"  # the CUDA symbol of kernels 2 and 4


def read(ctx):
    n = ctx.counters
    device_s = ctx.trace.device_s(KERNEL, kinds=("kernel",))
    if not device_s or not n.get("jobs"):
        return None
    k = n["keypoints"]
    least = counts.match_least_s(n["jobs"] * n["pairs_per_job"], k, k, n["dim"], "fp32")
    return 100.0 * least / device_s
