"""Trainer loop: the TimeStats phase ``merge_rounds`` over the merges, in
ms a merge, over the window's jobs that no profiler slowed."""


def read(run):
    jobs = run.untraced_jobs()
    merges = sum(j.merges for j in jobs)
    if not merges:
        return None
    return sum(j.phases.get("merge_rounds", (0.0, 0))[0] for j in jobs) / merges * 1e3
