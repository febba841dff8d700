"""The backbone MLP's share of its roofline (``models/dinov2.py`` ``Mlp``,
GELU or SwiGLU): the least time of the window's MLP calls over the device
time of the work launched inside the program's ``vc.backbone.mlp`` spans,
one a block (the weights' casts, the products, the activation).  A call's
least time is ``roofline.dinov2_counts.mlp_least_s``: the larger of its
products' operations over the bf16 peak and its bytes over the memory's
rate.  A program that opens no such span gives nothing."""

import bisect

from benchmark.harness import program_spans as ps
from benchmark.roofline import dinov2_counts

SPAN = "vc.backbone.mlp"


def device_s_under(trace, names) -> float:
    """Device seconds of the work the main thread launched inside the span
    set ``names`` (launches linked to their kernels by correlation id).
    ``Trace.device_s_under`` reads only ``user_annotation`` spans; the
    program's spans may be typed ``cpu_op``."""
    covered = ps.spans(trace, names)
    starts = [a for a, _ in covered]
    corr = set()
    for e in trace.launches:
        if e[5] != trace.main_thread:
            continue
        i = bisect.bisect_right(starts, e[2]) - 1
        if i >= 0 and e[2] < covered[i][1]:
            corr.add(e[4])
    return sum(e[3] - e[2] for e in trace.device if e[4] in corr) * 1e-9


def read(ctx):
    c = ctx.config
    batches = ctx.counters.get("batches", 0)
    device_s = device_s_under(ctx.trace, SPAN) if batches else 0.0
    if not device_s:
        return None
    least = batches * c["num_hidden_layers"] * dinov2_counts.mlp_least_s(
        ctx.traffic["image_batch"], c)
    return 100.0 * least / device_s
