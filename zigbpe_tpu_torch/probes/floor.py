"""The streaming floor: a blocked copy against block size and dtype.

Port of ``scripts/probe_floor.py``. ``passes`` chained copies of a
(rows, 128) array of zeros run between two events, for int32 and int16 and
each block of R rows, and each row reports ms per pass, the effective
bandwidth (one read and one write of the array per pass) and its share of
the card's 3.35 TB/s.
"""

from __future__ import annotations

import torch

from ..ops.core import resolve_device
from ..ops.kernels import LAYOUT
from ..ops.kernels import copy as kcopy
from . import PEAK_BYTES_PER_S, device_line, spread, time_runs

BLOCK_ROWS = (128, 256, 512, 1024, 2048)
DTYPES = (torch.int32, torch.int16)


def run(device="cuda", n_tokens: int = 1 << 25, block_rows=BLOCK_ROWS, passes: int = 64,
        runs: int = 5) -> list[dict]:
    """Time the copy at every dtype and block size; print and return one
    row each."""
    dev = resolve_device(device)
    rows = n_tokens // LAYOUT
    print(device_line(dev))
    print(f"floor: blocked copy of {n_tokens} tokens, {passes} chained passes per run, "
          f"median [min-max] of {runs} runs")
    out = []
    for dtype in DTYPES:
        x = torch.zeros((rows, LAYOUT), dtype=dtype, device=dev)
        nbytes = x.numel() * x.element_size()
        for R in block_rows:
            def chain(R=R):
                t = x
                for _ in range(passes):
                    t = kcopy.copy_blocks(t, R)

            ms, lo, hi = spread(time_runs(chain, dev, runs), passes)
            row = {"dtype": str(dtype).removeprefix("torch."), "R": R, "blocks": rows // R,
                   "ms": ms, "ms_min": lo, "ms_max": hi}
            line = (f"copy {row['dtype']:6s} R={R:5d} blocks={rows // R:6d}: {ms:9.4f} ms/pass "
                    f"[{lo:.4f}-{hi:.4f}]")
            if dev.type == "cuda":
                row["gb_s"] = 2 * nbytes / (ms / 1e3) / 1e9
                row["peak_share"] = row["gb_s"] * 1e9 / PEAK_BYTES_PER_S
                line += f"  {row['gb_s']:7.1f} GB/s eff  {row['peak_share']:.3f} of 3.35 TB/s"
            print(line)
            out.append(row)
    return out
