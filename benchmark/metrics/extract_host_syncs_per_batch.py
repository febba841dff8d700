"""CUDA runtime calls a batch that make the extractor's host wait for the
card (stream, device and event synchronizations, plain ``cudaMemcpy``),
started inside the program's ``vc.extract.batch`` span: every phase of
``ViTExtractor.extract_batch``.  A count: it repeats exactly from seed to
seed."""

from benchmark.harness import program_spans as ps

PHASES = ("vc.extract.batch",)


def read(ctx):
    return ps.per(ctx.trace, ctx.counters, "batches", PHASES, ps.syncs)
