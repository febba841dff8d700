"""Device-idle milliseconds a batch while the extractor read its outputs
back to host memory: the program's ``vc.extract.readback`` span around the
four ``.cpu().numpy()`` of ``ViTExtractor.extract_batch``."""

from benchmark.harness import program_spans as ps

PHASES = ("vc.extract.readback",)


def read(ctx):
    ns = ps.per(ctx.trace, ctx.counters, "batches", PHASES, ps.idle_ns)
    return None if ns is None else ns * 1e-6
