"""Share of the window in which the card is idle, no full collection runs,
and the batcher's worker is in no leaf stage (in a parent's own code, or
between dispatches), %: the idle time the program's stages do not
explain."""

from benchmark import program_trace
from benchmark.readers import Run


def read(run: Run):
    recs = program_trace.records(run)
    idle = program_trace.idle_intervals(run)
    if not recs or idle is None:
        return None
    workers = {d.thread for d in recs if d.name == "batcher.dispatch"}
    if not workers:
        return None
    covered = program_trace.union(
        [(r.t0, r.t1) for r in recs
         if r.name == "runtime.gc" or (r.name in program_trace.LEAVES and r.thread in workers)])
    covered = program_trace.clip(covered, run.window)
    idle_s = sum(t - s for s, t in idle)
    return 100.0 * (idle_s - program_trace.overlap_s(idle, covered)) / run.seconds
