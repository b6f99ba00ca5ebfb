"""Device: the share of the traced slices' wall time in which no operation
ran on the card, 1 - (union of device intervals / slice time)."""


def read(run):
    if run.trace is None or not run.trace.busy_s or not run.trace.window_s:
        return None
    return 1.0 - run.trace.busy_s / run.trace.window_s
