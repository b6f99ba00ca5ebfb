"""Trainer loop: lazy selection's exact verify passes a merge, the
program's counter ``verify_passes`` over its counter ``merges``, each summed
over the window's jobs that no profiler slowed. None where the jobs hold no
such counters, as with a program that records none."""

COUNTER = "verify_passes"


def read(run):
    jobs = [j for j in run.untraced_jobs() if COUNTER in j.counters and "merges" in j.counters]
    merges = sum(j.counters["merges"] for j in jobs)
    if not merges:
        return None
    return sum(j.counters[COUNTER] for j in jobs) / merges
