"""Merge pass: the device time of ``csrc/merge.cu``'s kernel in the traced
chunks of a job over the merges those chunks made, counted from the lines
the trainer prints with ``verbose`` after each chunk, in ms."""

KERNEL = "merge_kernel"


def read(run):
    if run.trace is None or not run.traced_merges or not run.trace.kernel_s(KERNEL):
        return None
    return run.trace.kernel_s(KERNEL) / run.traced_merges * 1e3
