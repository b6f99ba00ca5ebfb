"""The encode kernel over the config-3 serving path: a frozen 1024-merge
table over the staged corpus in rows.

    python -m zigbpe_tpu_torch.probes encode [--mb 32] [--row 32768]

Port of ``scripts/probe_encode.py``. The table is trained by the native
trainer on the first MiB and grouped by ``group_merges`` at its default cap
(16: consecutive chain-free runs, not the ``schedule_merges`` of config 3).
The whole ``row``-token rows of the corpus tiled to ``nbytes`` are staged
(``core.pad_tokens``) and viewed as [rows, row]; ``encode_rows_grouped``
replays the table over them: one warm-up run, then ``runs`` runs, each printed as MB/s (CUDA
events on the card, the host clock on the CPU), and the tokens out.
"""

from __future__ import annotations

import sys

import torch

from ..measure import device_field, host_ms, native_table, replay_rows, stage_rows
from ..native import fastio
from ..ops.core import resolve_device
from ..ops.kernels import encode as ke
from . import device_line, time_runs
from .budget import tiled_corpus


def run(device="cuda", nbytes: int = 32 << 20, row: int = 32768, runs: int = 3) -> dict:
    """Replay the grouped table over the rows; print and return MB/s of
    each run, the passes and the tokens out."""
    dev = resolve_device(device)
    if not fastio.available():
        raise RuntimeError("the native library did not build: no table to replay")
    data = tiled_corpus(nbytes)
    table, ms = host_ms(lambda: native_table(data), torch.device("cpu"))
    print(f"native table train: {ms / 1e3:.1f}s", file=sys.stderr)
    gt, gl = ke.group_merges(table)
    print(f"fused passes: {len(gl)} for {len(table)} merges", file=sys.stderr)
    gt, gl = torch.from_numpy(gt).to(dev), torch.from_numpy(gl).to(dev)

    rows, _ = stage_rows(data, row, dev)
    mbps, tokens_out = replay_rows(rows, gt, gl, lambda fn: time_runs(fn, dev, runs))
    print(device_line(dev))
    print(f"encode {len(data) / (1 << 20):g} MB rows={row}: {max(mbps):.1f} MB/s  "
          f"(runs {[f'{r:.1f}' for r in mbps]})")
    print(f"tokens out: {tokens_out}")
    return {"device": device_field(dev), "rows": rows.shape[0], "row_tokens": row,
            "fused_passes": len(gl), "runs_mbps": mbps, "tokens_out": tokens_out}
