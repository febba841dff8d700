"""Device-idle milliseconds a matching job while ``match_exhaustive``
launched its pair chunks: the host's index tensors and their copies,
kernel 2 and the compaction, inside the program's ``vc.match.launch``
span."""

from benchmark.harness import program_spans as ps

PHASES = ("vc.match.launch",)


def read(ctx):
    ns = ps.per(ctx.trace, ctx.counters, "jobs", PHASES, ps.idle_ns)
    return None if ns is None else ns * 1e-6
