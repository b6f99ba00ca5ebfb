"""Does int16 pay on the card's integer ALUs? The merge kernel's op mix in
int32 against packed int16.

Port of ``scripts/probe_alu16.py``. ``passes`` chained calls of
``opmix`` on a (rows, 128) array of zeros in blocks of R rows run between
two events, for reps 0, 4 and 16 and each dtype. Each row reports ms per
pass; on the card also the effective bandwidth (one read and one write of
the array per pass) and its share of 3.35 TB/s. At each reps > 0 the probe
prints the int16 speedup, int32 time over int16 time.
"""

from __future__ import annotations

import torch

from ..ops.core import resolve_device
from ..ops.kernels import LAYOUT
from ..ops.kernels import opmix as kopmix
from . import PEAK_BYTES_PER_S, device_line, spread, time_runs

REPS = kopmix.REPS  # the script's 0, 4 and 16
DTYPES = (torch.int32, torch.int16)


def run(device="cuda", n_tokens: int = 1 << 25, block_rows: int = 256, reps=REPS,
        passes: int = 32, runs: int = 5) -> list[dict]:
    """Time the op mix at every reps and dtype; print and return one row
    each."""
    dev = resolve_device(device)
    rows = n_tokens // LAYOUT
    print(device_line(dev))
    print(f"alu16: op mix of {n_tokens} zeros, R={block_rows}, {passes} chained passes per "
          f"run, median [min-max] of {runs} runs")
    out = []
    for r in reps:
        ms_of = {}
        for dtype in DTYPES:
            x = torch.zeros((rows, LAYOUT), dtype=dtype, device=dev)
            nbytes = x.numel() * x.element_size()

            def chain(x=x, r=r):
                t = x
                for _ in range(passes):
                    t = kopmix.opmix(t, block_rows, r)

            ms, lo, hi = spread(time_runs(chain, dev, runs), passes)
            name = str(dtype).removeprefix("torch.")
            row = {"dtype": name, "reps": r, "ms": ms, "ms_min": lo, "ms_max": hi}
            line = f"{name} opmix x{r:<2d}: {ms:9.4f} ms/pass [{lo:.4f}-{hi:.4f}]"
            if dev.type == "cuda":
                row["gb_s"] = 2 * nbytes / (ms / 1e3) / 1e9
                row["peak_share"] = row["gb_s"] * 1e9 / PEAK_BYTES_PER_S
                line += f"  {row['gb_s']:7.1f} GB/s eff  {row['peak_share']:.3f} of 3.35 TB/s"
            print(line)
            out.append(row)
            ms_of[name] = ms
        if r:
            speedup = ms_of["int32"] / ms_of["int16"]
            out[-1]["int16_speedup"] = speedup
            print(f"  -> int16 ALU speedup at reps={r}: {speedup:.2f}x")
    return out
