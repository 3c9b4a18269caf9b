"""Milliseconds a dispatch in ``DeviceIndex.search_hybrid`` (query analysis,
the dense kernel, lexical generation, rescore and fusion; the span ends
after a device synchronize)."""

from benchmark.readers import Run, mean_span_ms


def read(run: Run):
    return mean_span_ms(run, "search_hybrid")
