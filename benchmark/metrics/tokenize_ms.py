"""Milliseconds a dispatch in ``embed.tokenize`` (``EncoderService._forward``:
the tokenizer's ``encode_batch`` and the batch's padding, on the host)."""

from benchmark import program_trace
from benchmark.readers import Run


def read(run: Run):
    return program_trace.per_dispatch_ms(run, "embed.tokenize")
