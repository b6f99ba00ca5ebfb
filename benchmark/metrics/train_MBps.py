"""Training throughput: the corpus bytes (1e6) of every whole job in the
window over the window's wall time, the last job run to its end included."""


def read(run):
    if not run.jobs or run.window_s <= 0:
        return None
    return sum(j.nbytes for j in run.jobs) / run.window_s / 1e6
