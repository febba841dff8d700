"""Device-idle milliseconds a matching job while ``match_exhaustive`` read
the database (images, cameras, 64 keypoint blobs, their undistortion, the
descriptors) and assembled the padded, decoded and normalized descriptors:
the union of the program's ``vc.match.read`` and ``vc.match.assemble``
spans."""

from benchmark.harness import program_spans as ps

PHASES = ("vc.match.read", "vc.match.assemble")


def read(ctx):
    ns = ps.per(ctx.trace, ctx.counters, "jobs", PHASES, ps.idle_ns)
    return None if ns is None else ns * 1e-6
