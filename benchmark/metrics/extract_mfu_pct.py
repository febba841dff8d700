"""The backbone's model FLOPs over the window as a share of the card's bf16
peak (``models/dinov2.py``): each image's forward at the published widths,
counted from shapes (``roofline.counts.vit_forward_flops``), whatever
kernels did the work."""

from benchmark.roofline import counts


def read(ctx):
    c = ctx.config
    images = ctx.counters.get("images", 0)
    if not images:
        return None
    flops = images * counts.vit_forward_flops(c, c["image_height"], c["image_width"])
    return 100.0 * flops / ctx.trace.window_s / counts.peak_flops("bf16")
