"""The port's api/wsflow.py against the JAX package's, case for case: the
same generator and the same control frames through both packages'
``pump``, ``next_message`` and ``start_reader`` give the same outcome,
events sent, leftovers and generator finalization."""

import asyncio

import pytest

from super_rag_tpu.api import wsflow as jflow
from super_rag_tpu_torch.api import wsflow as tflow


async def gen_n(n, closed):
    try:
        for i in range(n):
            yield {"event": "delta", "data": {"i": i}}
    finally:
        closed.append(True)


async def _pump(mod, n, before=(), inject_at=None, inject=()):
    """``n`` events; ``before`` frames queued ahead, ``inject`` frames put
    when the ``inject_at``-th event is sent."""
    inbox = asyncio.Queue()
    for m in before:
        await inbox.put(m)
    sent, closed = [], []

    async def send(e):
        sent.append(e)
        if len(sent) == inject_at:
            for m in inject:
                await inbox.put(m)

    outcome, leftover = await mod.pump(gen_n(n, closed), inbox, send)
    return outcome, leftover, sent, closed, inbox.qsize()


PUMP_CASES = {
    "to completion": dict(n=3),
    "empty generator": dict(n=0),
    "stop mid-stream": dict(n=100, inject_at=2, inject=[{"type": "stop"}]),
    "cancel mid-stream": dict(n=100, inject_at=5, inject=[{"type": "cancel"}]),
    "stop before the first event": dict(n=5, before=[{"type": "stop"}]),
    "frame queued, then stop": dict(n=50, inject_at=1,
                                    inject=[{"message": "next"}, {"type": "stop"},
                                            {"message": "after stop"}]),
    "non-control frames queued": dict(n=2, before=[{"message": "next question"}]),
    "close mid-stream": dict(n=5, before=[None]),
    "close after a frame": dict(n=9, inject_at=3, inject=[{"message": "m"}, None]),
    "not a dict": dict(n=3, before=["text frame", 7, [1]]),
    "unknown type": dict(n=2, before=[{"type": "ping"}]),
}


@pytest.mark.parametrize("case", list(PUMP_CASES))
def test_pump_case_for_case(case):
    kw = PUMP_CASES[case]
    want = asyncio.run(_pump(jflow, **kw))
    got = asyncio.run(_pump(tflow, **kw))
    assert got == want
    # a generator that ran is finalized, not abandoned (one closed before
    # its first event never ran its body)
    ran = got[0] == "done" or any(e["event"] == "delta" for e in got[2])
    assert got[3] == ([True] if ran else [])


NEXT_CASES = {
    "leftovers first": ([{"message": "hi"}], [{"type": "cancel"}, {"message": "queued"}], 2),
    "bare stops skipped": ([{"type": "stop"}, {"type": "cancel"}, {"message": "x"}], [], 1),
    "close": ([None], [], 1),
    "stop then close": ([{"type": "stop"}, None], [], 1),
    "leftover close": ([], [None, {"message": "never"}], 1),
    "non-dict frames": (["raw", 3], [], 2),
}


async def _next(mod, queued, leftover, reads):
    inbox = asyncio.Queue()
    for m in queued:
        await inbox.put(m)
    left = list(leftover)
    out = [await mod.next_message(inbox, left) for _ in range(reads)]
    return out, left, inbox.qsize()


@pytest.mark.parametrize("case", list(NEXT_CASES))
def test_next_message_case_for_case(case):
    args = NEXT_CASES[case]
    assert asyncio.run(_next(tflow, *args)) == asyncio.run(_next(jflow, *args))


class FakeWS:
    def __init__(self, frames, error=None):
        self.frames = list(frames)
        self.error = error

    async def receive_json(self):
        if not self.frames:
            if self.error is not None:
                raise self.error
            await asyncio.sleep(3600)
        return self.frames.pop(0)


@pytest.mark.parametrize("frames,error", [
    ([{"message": "a"}, {"type": "stop"}, None], None),
    ([{"message": "a"}], ConnectionResetError()),
    ([], asyncio.IncompleteReadError(b"", 2)),
])
def test_start_reader_case_for_case(frames, error):
    async def go(mod):
        inbox = asyncio.Queue()
        task = mod.start_reader(FakeWS(frames, error), inbox)
        got = []
        while True:
            m = await asyncio.wait_for(inbox.get(), 5)
            got.append(m)
            if m is None:
                break
        await asyncio.wait_for(task, 5)
        return got

    assert asyncio.run(go(tflow)) == asyncio.run(go(jflow))
    assert tflow.STOP_TYPES == jflow.STOP_TYPES
