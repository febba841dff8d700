"""CUDA runtime calls a matching job that make the host wait for the card
(stream, device and event synchronizations, plain ``cudaMemcpy``), started
inside the program's ``vc.match.job`` span: every phase of
``match_exhaustive``.  A count: it repeats exactly from seed to seed."""

from benchmark.harness import program_spans as ps

PHASES = ("vc.match.job",)


def read(ctx):
    return ps.per(ctx.trace, ctx.counters, "jobs", PHASES, ps.syncs)
