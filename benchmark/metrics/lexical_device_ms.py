"""Milliseconds a dispatch that the card is busy inside ``index.lexical``'s
device interval (the inverted generation: the CSR gather, sort and
segment sum, and the fresh-tail merge): the union of the operations'
time within the stage's two events, over the dispatches that lie wholly
in the window."""

from benchmark import program_trace, trace
from benchmark.readers import Run


def read(run: Run):
    recs = program_trace.records(run)
    if not recs or run.device is None:
        return None
    ds = program_trace.dispatches(recs, run, whole=True)
    lex = [r.device for r in program_trace.of_dispatches(recs, ds, "index.lexical")
           if r.device is not None]
    if not lex:
        return None
    busy = trace.busy_intervals(run.device.kernels)
    return 1e3 * program_trace.overlap_s(busy, program_trace.union(lex)) / len(ds)
