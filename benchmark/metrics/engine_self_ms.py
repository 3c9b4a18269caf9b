"""Milliseconds a dispatch of ``search_batch`` outside its embed,
``search_hybrid`` and rerank spans: padding, the copies to the host and
building the hits."""

from benchmark.readers import Run, dispatch_spans


def read(run: Run):
    per = [d["search_batch"] - sum(v for k, v in d.items()
                                   if k not in ("search_batch", "_range"))
           for d in dispatch_spans(run)]
    return 1e3 * sum(per) / len(per) if per else None
