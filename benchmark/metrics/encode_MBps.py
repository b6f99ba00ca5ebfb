"""Encode throughput: the document bytes (1e6) of every call in the
window over the window's wall time, the last call run to its end included."""


def read(run):
    if not run.calls or run.window_s <= 0:
        return None
    return sum(c.nbytes for c in run.calls) / run.window_s / 1e6
