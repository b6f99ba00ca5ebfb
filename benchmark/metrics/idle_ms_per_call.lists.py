"""Serving front: the device's idle time while the host was inside the
program's ``encode.lists`` span of ``encode_batch`` (the row lengths read
and a list of ids made for each row), in ms a traced call. None where the
traced slices saw no device work, or the program records no such span."""

SPAN = "encode.lists"


def read(run):
    t, calls = run.trace, len(run.traced_calls())
    if t is None or not t.busy_s or SPAN not in t.idle_s or not calls:
        return None
    return t.idle_s[SPAN] / calls * 1e3
