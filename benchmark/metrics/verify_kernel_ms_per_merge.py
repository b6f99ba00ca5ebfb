"""Trainer loop: the device time of ``csrc/count.cu``'s kernel, the exact
count of lazy selection's verify passes, in the traced chunks of a job over
the merges those chunks made, counted from the lines the trainer prints
with ``verbose`` after each chunk, in ms. A program without that kernel
reads nothing."""

KERNEL = "count_queries_kernel"


def read(run):
    if run.trace is None or not run.traced_merges or not run.trace.kernel_s(KERNEL):
        return None
    return run.trace.kernel_s(KERNEL) / run.traced_merges * 1e3
