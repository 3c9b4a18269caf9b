"""Milliseconds a dispatch in ``CollectionEngine._maybe_rerank`` with rerank
on: pair tokenization, the cross-encoder's forwards and the fusion."""

from benchmark.readers import Run, mean_span_ms


def read(run: Run):
    return mean_span_ms(run, "rerank")
