"""Device operations an encoder forward runs: those that start inside an
``embed.forward`` stage's device interval (its two events on the card:
the copies of the token ids and mask, and the model's kernels), over
the forwards of the dispatches that lie wholly in the window."""

import bisect

from benchmark import program_trace
from benchmark.readers import Run


def read(run: Run):
    recs = program_trace.records(run)
    if not recs or run.device is None:
        return None
    ds = program_trace.dispatches(recs, run, whole=True)
    fwd = [r.device for r in program_trace.of_dispatches(recs, ds, "embed.forward")
           if r.device is not None]
    if not fwd:
        return None
    starts = sorted(s for _, s, _ in run.device.kernels)
    return sum(bisect.bisect_right(starts, d1) - bisect.bisect_left(starts, d0)
               for d0, d1 in fwd) / len(fwd)
