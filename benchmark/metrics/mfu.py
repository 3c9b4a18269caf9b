"""The whole step's share of the card's peak, %: the least time at the
published peaks of all the model and scoring work of the window (encoder
and cross-encoder forwards over the tokens the inputs need, the dense
products at the storage type), over the window."""

from benchmark.readers import Run, window_work_s


def read(run: Run):
    t = window_work_s(run)
    return None if t is None else 100.0 * t / run.seconds
