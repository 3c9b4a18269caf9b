"""Milliseconds a dispatch in ``engine.hits`` (``CollectionEngine._hits`` for
each query: a ``SearchHit`` and a metadata dict a hit), less the full
collections (``runtime.gc``) that ran inside it."""

from benchmark import program_trace
from benchmark.readers import Run


def read(run: Run):
    recs = program_trace.records(run)
    ds = program_trace.dispatches(recs, run) if recs else []
    hits = program_trace.of_dispatches(recs, ds, "engine.hits") if ds else []
    if not hits:
        return None
    gcs = program_trace.union((r.t0, r.t1) for r in recs if r.name == "runtime.gc")
    spans = program_trace.union((r.t0, r.t1) for r in hits)
    own = sum(r.t1 - r.t0 for r in hits) - program_trace.overlap_s(spans, gcs)
    return 1e3 * own / len(ds)
