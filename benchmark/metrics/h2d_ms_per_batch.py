"""Device milliseconds of host-to-device copies per extraction batch: the
extractor's entry and wire (``ViTExtractor.to_wire``, ``ops/transfer.py``)."""

COPIES = r"HtoD"  # the profiler's name of a host-to-device memcpy


def read(ctx):
    batches = ctx.counters.get("batches", 0)
    if not batches or not ctx.trace.count(COPIES, kinds=("gpu_memcpy",)):
        return None
    return 1e3 * ctx.trace.device_s(COPIES, kinds=("gpu_memcpy",)) / batches
