"""Device-idle milliseconds a matching job while ``match_exhaustive`` read
back each chunk's counts and packed prefix and unpacked them pair by pair:
the program's ``vc.match.unpack`` span."""

from benchmark.harness import program_spans as ps

PHASES = ("vc.match.unpack",)


def read(ctx):
    ns = ps.per(ctx.trace, ctx.counters, "jobs", PHASES, ps.idle_ns)
    return None if ns is None else ns * 1e-6
