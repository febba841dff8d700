"""Kernel 1's share of its roofline (``csrc/fixed_max_attention.cu``,
``kernels/attention.py``) in a DINOv2 with registers: the least time of the
calls in the window over the kernel's device time.  A batch calls it once a
block, over the patches, the cls and the register tokens
(``roofline.dinov2_counts.tokens``); a call's least time is that of
``counts.attention_least_s``."""

from benchmark.roofline import counts, dinov2_counts

KERNEL = r"\battention_kernel\b"  # the CUDA symbol of both bodies


def read(ctx):
    c = ctx.config
    device_s = ctx.trace.device_s(KERNEL, kinds=("kernel",))
    if not device_s:
        return None
    calls = ctx.counters["batches"] * c["num_hidden_layers"]
    least = calls * counts.attention_least_s(ctx.traffic["image_batch"],
                                             dinov2_counts.tokens(c), c["hidden_size"], "bf16")
    return 100.0 * least / device_s
