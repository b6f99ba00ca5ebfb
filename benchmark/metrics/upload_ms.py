"""Staging and host seed: the TimeStats phases ``initial_tokens`` and
``count_pairs`` of a job, in ms, the mean over the window's jobs that no
profiler slowed."""


def read(run):
    jobs = run.untraced_jobs()
    if not jobs:
        return None
    per_job = [sum(j.phases.get(p, (0.0, 0))[0] for p in ("initial_tokens", "count_pairs"))
               for j in jobs]
    return sum(per_job) / len(per_job) * 1e3
