"""Device-idle milliseconds a batch while the extractor packed its batch
and copied it to the card: the union of the program's ``vc.extract.wire``
(``ViTExtractor.to_wire``, the tensor and its padding in ``_over_slots``)
and ``vc.extract.h2d`` (``parallel/mesh.shard_batch``, the pageable copy)
spans."""

from benchmark.harness import program_spans as ps

PHASES = ("vc.extract.wire", "vc.extract.h2d")


def read(ctx):
    ns = ps.per(ctx.trace, ctx.counters, "batches", PHASES, ps.idle_ns)
    return None if ns is None else ns * 1e-6
