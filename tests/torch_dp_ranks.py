"""Run cases of the port's data-parallel trainer on a gloo group of local
ranks, for the tests of ``zigbpe_tpu_torch.parallel``.

:func:`run` starts one process per rank (this file as a script, importing
only torch and the port), gives every rank the same list of cases and
returns each rank's results. A group that diverges fails: each rank's
collectives time out after ``GROUP_TIMEOUT_S``, and the caller's wait kills
every rank after ``timeout``.

A case is a dict with a ``kind`` (a key of ``CASES``) and its arguments;
the results are plain Python values and numpy arrays.
"""

from __future__ import annotations

import os
import pickle
import shutil
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
GROUP_TIMEOUT_S = 60


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run(world: int, cases: list, timeout: float = 120.0) -> list:
    """Each rank's list of case results, in rank order."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "cases.pkl").write_bytes(pickle.dumps(cases))
        env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
        port = free_port()
        procs = [subprocess.Popen(
            [sys.executable, __file__, str(r), str(world), str(port), str(tmp)],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        ) for r in range(world)]
        try:
            outs = [p.communicate(timeout=timeout) for p in procs]
        finally:
            for p in procs:
                p.kill()
        for r, (p, (_, err)) in enumerate(zip(procs, outs)):
            assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{err.decode()[-3000:]}"
        return [pickle.loads((tmp / f"rank{r}.pkl").read_bytes()) for r in range(world)]


# ------------------------------------------------------------------ children

class _SnapshotStats:
    """A TimeStats stand-in that copies ``src`` to ``dst`` when the
    ``at``-th ``merge_rounds`` phase starts: the checkpoint a run had
    written by then (rank 0 only)."""

    def __init__(self, src, dst, at: int, rank: int):
        self.src, self.dst, self.at, self.rank, self.seen = src, dst, at, rank, 0

    def phase(self, name, device=None):
        import contextlib

        if name == "merge_rounds":
            self.seen += 1
            if self.seen == self.at and self.rank == 0:
                shutil.copytree(self.src, self.dst)
        return contextlib.nullcontext()


def _case_train(c, g, dp):
    """train_dp, or train_dp_tokens on a given per-shard capacity."""
    if "per_shard_capacity" in c:
        tokens = dp.shard_corpus(c["data"], g, "cpu", per_shard_capacity=c["per_shard_capacity"])
        return dp.train_dp_tokens(tokens, len(c["data"]), c["vocab"], g, ub_max_row=256,
                                  **c.get("kwargs", {}))
    stats = None
    if "snapshot" in c:
        src, dst, at = c["snapshot"]
        stats = _SnapshotStats(src, dst, at, g.rank)
    return dp.train_dp(c["data"], c["vocab"], g, device="cpu", stats=stats,
                       **c.get("kwargs", {}))


def _case_init_ub(c, g, dp):
    tokens = dp.shard_corpus(c["data"], g, "cpu")
    if c.get("max_row"):
        return dp.init_ub_sharded_dp(tokens, c["vocab"], g, max_row=c["max_row"]).numpy()
    return dp.init_ub_dp(tokens, c["vocab"], g).numpy()


def _case_merge(c, g, dp):
    """One shard merge on the rank's given shard: (tokens, [hits, kept, bad])."""
    import torch

    tokens = torch.from_numpy(c["shards"][g.rank].copy())
    edges = dp._gather_edges(tokens, g)
    ta, tb, new = c["pair"]
    if ta == tb:
        out, st = dp._parity_merge_shard(tokens, ta, new, edges, g)
    else:
        out, st = dp._kernel_merge_shard(tokens, ta, tb, new, edges, g.rank)
    return out.numpy(), st.tolist()


def _case_files(c, g, dp):
    from zigbpe_tpu_torch.parallel import multihost

    tokens, total = dp.shard_corpus_from_files(c["paths"], g, "cpu")
    merges = multihost.train_from_files(c["paths"], c["vocab"], g, device="cpu",
                                        **c.get("kwargs", {}))
    return merges, int((tokens >= 0).sum()), total


def _case_seeded(c, g, dp):
    """train_dp with its host seeds counted: (merges, host seeds taken,
    count_pairs calls)."""
    from zigbpe_tpu_torch.utils.profiling import TimeStats

    taken = []
    saved = dp._byte_pair_entries, dp._host_pair_entries
    dp._byte_pair_entries = lambda d: taken.append("bytes") or saved[0](d)
    dp._host_pair_entries = lambda ids: taken.append("ids") or saved[1](ids)
    stats = TimeStats()
    try:
        merges = dp.train_dp(c["data"], c["vocab"], g, device="cpu", stats=stats,
                             **c.get("kwargs", {}))
    finally:
        dp._byte_pair_entries, dp._host_pair_entries = saved
    return merges, taken, stats.phases["count_pairs"].calls


CASES = {"train": _case_train, "init_ub": _case_init_ub, "merge": _case_merge,
         "files": _case_files, "seeded": _case_seeded}


def _child(rank: int, world: int, port: int, tmp: Path) -> None:
    import datetime

    import torch
    import torch.distributed as dist

    from zigbpe_tpu_torch.parallel import train_dp as dp

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    g = dp.data_group()
    results, lazy_max = [], dp.LAZY_VOCAB_MAX
    for c in pickle.loads((tmp / "cases.pkl").read_bytes()):
        dp.LAZY_VOCAB_MAX = c.get("lazy_vocab_max", lazy_max)
        results.append(CASES[c["kind"]](c, g, dp))
    (tmp / f"rank{rank}.pkl").write_bytes(pickle.dumps(results))
    dist.destroy_process_group()


if __name__ == "__main__":
    _child(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
