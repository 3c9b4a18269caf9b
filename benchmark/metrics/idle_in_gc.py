"""Share of the window in which the card is idle while a full collection
(the program's ``runtime.gc`` stage) runs, %: the part of the device's
idle time that the interpreter's collector holds."""

from benchmark import program_trace
from benchmark.readers import Run


def read(run: Run):
    recs = program_trace.records(run)
    idle = program_trace.idle_intervals(run)
    if not recs or idle is None:
        return None
    gcs = program_trace.gc_intervals(recs, run.window)
    return 100.0 * program_trace.overlap_s(idle, gcs) / run.seconds
