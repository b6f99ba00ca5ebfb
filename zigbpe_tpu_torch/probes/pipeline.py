"""Copies shaped like the merge pass's grid, against the merge pass.

Port of ``scripts/probe_pipeline.py``. On a (rows, 128) int32 array of
zeros in blocks of R rows: the blocked copy, the copy with a count carried
over all blocks (``copy_carry``), the copy with the count and each block's
look-ahead read (``copy_peek``, the merge pass's read of the next tile's
head), and the production merge pass with (101, 32) -> 300, which never
hits on zeros; one call of each per run. With ``loop``: ``passes`` chained
copies against ``passes`` merge passes, per pass.
"""

from __future__ import annotations

import torch

from ..ops.core import resolve_device
from ..ops.kernels import LAYOUT
from ..ops.kernels import copy as kcopy
from ..ops.kernels import merge as kmerge
from . import device_line, spread, time_runs

MERGE = (101, 32, 300)


def run(device="cuda", n_tokens: int = 1 << 25, block_rows: int = 256, loop: bool = False,
        passes: int = 64, runs: int = 5) -> list[dict]:
    """Time the pipeline cases; print and return one row each."""
    dev = resolve_device(device)
    x = torch.zeros((n_tokens // LAYOUT, LAYOUT), dtype=torch.int32, device=dev)
    flat = x.view(-1)
    table = torch.tensor([MERGE], dtype=torch.int32, device=dev)

    def merge():
        kmerge.merge_pass_multi(flat, table)

    if loop:
        def copies():
            t = x
            for _ in range(passes):
                t = kcopy.copy_blocks(t, block_rows)

        def merges():
            for _ in range(passes):
                merge()

        cases, per = [(f"copy x{passes}", copies), (f"merge x{passes}", merges)], passes
    else:
        cases = [
            ("copy", lambda: kcopy.copy_blocks(x, block_rows)),
            ("copy+carry", lambda: kcopy.copy_carry(x, block_rows)),
            ("copy+peek", lambda: kcopy.copy_peek(x, block_rows)),
            ("merge", merge),
        ]
        per = 1
    print(device_line(dev))
    print(f"pipeline: {n_tokens} int32 zeros, R={block_rows}, "
          f"{'ms per pass' if loop else 'ms per call'}, median [min-max] of {runs} runs")
    out = []
    for name, fn in cases:
        ms, lo, hi = spread(time_runs(fn, dev, runs), per)
        print(f"{name:12s}: {ms:9.4f} ms [{lo:.4f}-{hi:.4f}]")
        out.append({"case": name, "ms": ms, "ms_min": lo, "ms_max": hi})
    return out
