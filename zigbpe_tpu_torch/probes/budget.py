"""Op-level budget of the merge pass: ablated copies of the merge kernel.

Port of ``scripts/probe_merge_budget.py``. The protocol:
1. the conformance corpus tiled to ``nbytes`` (as ``bench.py`` tiles it),
   uploaded at the trainer's capacity;
2. the first NP merges the port's own trainer learns on it, on ``device``;
3. the NP input streams of those merges, made by the production pass, one
   merge per pass, stacked;
4. for every variant of ``ops.kernels.merge.VARIANTS``: the stacked
   streams are copied into a work buffer outside the timed span (the pass
   is in place), then all NP passes run between two events. Each row is
   ms per pass, with the stats the Pallas probe reports (hits summed over
   the passes, the last pass's length and min_kept), and its delta against
   ``full``;
5. on a CUDA device, ``torch.profiler`` over one replay of ``full`` gives
   the device time of the pass's one launch (``merge_kernel``).
"""

from __future__ import annotations

from pathlib import Path

import torch

from .. import train
from ..ops.core import resolve_device
from ..ops.kernels import merge as kmerge
from . import device_line, spread, time_runs

CORPUS = Path(__file__).resolve().parents[2] / "tests" / "data" / "taylorswift.txt"
LAUNCHES = ("merge_kernel",)  # the pass is one launch


def tiled_corpus(nbytes: int, corpus: Path = CORPUS) -> bytes:
    """``corpus`` repeated and cut to ``nbytes`` bytes."""
    seed = corpus.read_bytes()
    return (seed * (nbytes // len(seed) + 1))[:nbytes]


def streams(data: bytes, np_passes: int, device: torch.device):
    """(merges [NP, 1, 3], stacked [NP, N]): the trainer's first NP merges
    on ``data`` and the input stream of each, made by the production pass."""
    merges = train.train(data, 256 + np_passes, device=device)
    if len(merges) != np_passes:
        raise ValueError(f"the corpus gave {len(merges)} merges, fewer than {np_passes}")
    table = torch.tensor(merges, dtype=torch.int32, device=device).view(np_passes, 1, 3)
    tokens, _, _ = train.upload(data, device)
    stacked = torch.empty((np_passes, tokens.shape[0]), dtype=torch.int32, device=device)
    stacked[0] = tokens
    for p in range(np_passes - 1):
        t = stacked[p].clone()
        kmerge.merge_pass_multi(t, table[p])
        stacked[p + 1] = t
    return table, stacked


def launch_times(replay, device: torch.device) -> dict:
    """Device microseconds per call of each kernel of ``LAUNCHES`` in one
    ``replay()``, from ``torch.profiler``; empty when it saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        replay()
        torch.cuda.synchronize(device)
    totals = {}
    for evt in prof.key_averages():
        us = getattr(evt, "device_time_total", 0)
        name = next((n for n in LAUNCHES if n in evt.key), None)
        if name and us > 0:
            total, count = totals.get(name, (0.0, 0))
            totals[name] = (total + us, count + evt.count)
    return {name: total / count for name, (total, count) in totals.items()}


def run(device="cuda", nbytes: int = 32 << 20, np_passes: int = 16, runs: int = 5) -> dict:
    """Replay every variant over the NP streams; print and return the rows
    (by variant) and, on a CUDA device, the launch times of ``full``."""
    dev = resolve_device(device)
    data = tiled_corpus(nbytes)
    table, stacked = streams(data, np_passes, dev)
    work = torch.empty_like(stacked)

    def replay(variant):
        return [kmerge.merge_pass_ablated(work[p], table[p], variant)[1]
                for p in range(np_passes)]

    def restore():
        work.copy_(stacked)

    print(device_line(dev))
    print(f"budget: {len(data)} bytes at capacity {stacked.shape[1]}, {np_passes} passes of "
          f"the trainer's first merges, ms per pass, median [min-max] of {runs} runs")
    rows = {}
    for name in kmerge.VARIANTS:
        last = {}

        def timed(name=name):
            last["stats"] = replay(name)

        ms, lo, hi = spread(time_runs(timed, dev, runs, setup=restore), np_passes)
        st = torch.stack(last["stats"]).cpu()
        rows[name] = {"ms": ms, "ms_min": lo, "ms_max": hi, "hits": int(st[:, 0].sum()),
                      "length": int(st[-1, 1]), "min_kept": int(st[-1, 2])}
        print(f"{name:10s}: {ms:9.4f} ms/pass [{lo:.4f}-{hi:.4f}]  hits {rows[name]['hits']} "
              f"length {rows[name]['length']} min_kept {rows[name]['min_kept']}")
    print("budget (full minus variant; positive = what the piece costs):")
    for name, row in rows.items():
        if name != "full":
            row["delta_ms"] = rows["full"]["ms"] - row["ms"]
            print(f"{name:10s}: {row['delta_ms']:+9.4f} ms")
    launches = {}
    if dev.type == "cuda":
        restore()
        launches = launch_times(lambda: replay("full"), dev)
        if launches:
            print("full, device us per launch (torch.profiler): " + ", ".join(
                f"{name.removesuffix('_kernel')} {us:.2f}" for name, us in launches.items()))
        else:
            print("full, device time per launch: not measured (the profiler saw none)")
    return {"rows": rows, "launches": launches}
