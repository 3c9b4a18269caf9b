"""Milliseconds a dispatch in ``CollectionEngine._embed`` (tokenization and
the encoder's forwards; the span ends after a device synchronize)."""

from benchmark.readers import Run, mean_span_ms


def read(run: Run):
    return mean_span_ms(run, "embed")
