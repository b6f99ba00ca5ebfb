"""Trainer loop: the device's idle time while the host was inside the
program's ``train.select`` span (a group member's selection: its verify
passes and their waits, the argmax read, the acceptance test), in ms a
merge of the traced chunks. None where the traced slices saw no device
work, or the program records no such span."""

SPAN = "train.select"


def read(run):
    t = run.trace
    if t is None or not t.busy_s or SPAN not in t.idle_s or not run.traced_merges:
        return None
    return t.idle_s[SPAN] / run.traced_merges * 1e3
