"""The backbone's model FLOPs over the window as a share of the card's bf16
peak, for a DINOv2 with registers and either MLP form
(``models/dinov2.py``): each image's forward at the published widths,
counted from shapes (``roofline.dinov2_counts.forward_flops``: SwiGLU's
three products, the cls and register tokens), whatever kernels did the
work."""

from benchmark.roofline import counts, dinov2_counts


def read(ctx):
    images = ctx.counters.get("images", 0)
    if not images:
        return None
    flops = images * dinov2_counts.forward_flops(ctx.config)
    return 100.0 * flops / ctx.trace.window_s / counts.peak_flops("bf16")
