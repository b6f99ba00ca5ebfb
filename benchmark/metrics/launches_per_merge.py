"""Launch path: the device kernels (not copies or fills) of the traced
chunks of a job over the merges those chunks made, counted from the lines
the trainer prints with ``verbose`` after each chunk."""


def read(run):
    if run.trace is None or not run.traced_merges or not run.trace.kernel_count():
        return None
    return run.trace.kernel_count() / run.traced_merges
