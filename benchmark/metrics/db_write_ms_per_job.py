"""Host milliseconds per matching job in the database writer
(``database/native.py`` over ``csrc/host/db_writer.cc``): opening it, its
``add_matches``, ``commit`` and ``close``, inside the ``bench.db_write``
spans that the traced run wraps around ``pipeline.match.open_bulk_writer``."""


def read(ctx):
    jobs = ctx.counters.get("jobs", 0)
    spans = ctx.trace.spans("bench.db_write")
    if not jobs or not spans:
        return None
    return 1e3 * sum(b - a for a, b in spans) * 1e-9 / jobs
