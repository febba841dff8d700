"""Kernel 1's share of its roofline (``csrc/fixed_max_attention.cu``,
``kernels/attention.py``): the least time of the calls in the window over
the kernel's device time.  A batch calls it once a block; a call's least
time is the larger of 4 * B * N^2 * D operations over the bf16 peak and the
packed qkv read plus the output written over the memory's rate."""

from benchmark.roofline import counts

KERNEL = r"\battention_kernel\b"  # the CUDA symbol of both bodies


def read(ctx):
    c = ctx.config
    device_s = ctx.trace.device_s(KERNEL, kinds=("kernel",))
    if not device_s:
        return None
    tokens = counts.vit_tokens(c["image_height"], c["image_width"], c["patch_size"])
    calls = ctx.counters["batches"] * c["num_hidden_layers"]
    least = calls * counts.attention_least_s(ctx.traffic["image_batch"], tokens,
                                             c["hidden_size"], "bf16")
    return 100.0 * least / device_s
