"""What exact counts kept inside a blocked copy cost: the building block
of exact pair-count maintenance.

Port of ``scripts/probe_hist.py``. On a (rows, 128) int32 array of seeded
tokens in [0, 500), ``passes`` chained calls of ``onehot_hist`` (each call
copies the array and builds two masked V-bin histograms of it, hits
``t % 7 == 0``) run between two events, at each V of 512, 1280 and 4352:
subchunks of S = 8 and 32 rows without skip, and S = 32 with skip on the
same data (every subchunk has a hit) and with no hits at all (every
subchunk skipped). The plain blocked copy (``copy_blocks``) at the same R
is the baseline. Each row reports ms per pass and the ms it adds over the
copy; on the card also its bound (the bytes of the function: one read and
one write of the array and one write of the histogram), the share of that
bound the pass reaches, and, beside it, what the TPU's formulation of the
counts as bf16 one-hot products would take on the card's tensor cores
(2 * 128 * 2 Vh flops per token of every subchunk that runs, at peak).
The card's kernel counts with integer adds in shared memory and does no
products.
"""

from __future__ import annotations

import torch

from ..ops.core import resolve_device
from ..ops.kernels import LAYOUT
from ..ops.kernels import copy as kcopy
from ..ops.kernels import hist as khist
from . import PEAK_BF16_FLOPS, bound_ms, device_line, spread, time_runs

VOCABS = (512, 1280, 4352)
DENSITY = 7  # hit when t % 7 == 0
CASES = (  # (label, sub_rows, density_mod, skip): probe_hist.py:129-134
    ("S= 8 dense", 8, DENSITY, False),
    ("S=32 dense", 32, DENSITY, False),
    ("S=32 skip-on dense", 32, DENSITY, True),
    ("S=32 skip-on nohit", 32, 0, True),
)


def tokens(n_tokens: int, device: torch.device, seed: int = 0) -> torch.Tensor:
    """(n_tokens / 128, 128) int32 tokens in [0, 500), made on ``device``
    from ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, 500, (n_tokens // LAYOUT, LAYOUT), generator=g, device=device,
                         dtype=torch.int32)


def bound(x: torch.Tensor, vocab: int) -> tuple[float, str]:
    """(ms, "bytes"): the least time of one call on ``x``: the copy's read
    and write and the histogram's write. Counting a histogram needs no
    products, so no operations enter it."""
    nbytes = 2 * x.numel() * x.element_size() + 2 * khist.vocab_rows(vocab) * LAYOUT * 4
    return bound_ms(nbytes)


def onehot_mma_ms(x: torch.Tensor, rows_per_block: int, vocab: int, sub_rows: int,
                  density_mod: int, skip: bool) -> float:
    """The ms the TPU's one-hot products of the subchunks this data runs
    would take on the card's tensor cores at peak bf16: what that
    formulation costs here, beside the function's bound."""
    kept = int(khist.kept_subchunks(x, rows_per_block, sub_rows, density_mod, skip).sum())
    flops = 2 * LAYOUT * 2 * khist.vocab_rows(vocab) * kept * sub_rows * LAYOUT
    return flops / PEAK_BF16_FLOPS * 1e3


def run(device="cuda", n_tokens: int = 1 << 25, block_rows: int = 256, vocabs=VOCABS,
        passes: int = 32, runs: int = 5) -> list[dict]:
    """Time the copy and every histogram case; print and return one row
    each."""
    dev = resolve_device(device)
    x = tokens(n_tokens, dev)
    print(device_line(dev))
    print(f"hist: {n_tokens} int32 tokens in [0, 500), R={block_rows}, exact counts, "
          f"{passes} chained passes per run, median [min-max] of {runs} runs")

    def chain(fn):
        def go():
            t = x
            for _ in range(passes):
                t = fn(t)
        return go

    ms, lo, hi = spread(time_runs(chain(lambda t: kcopy.copy_blocks(t, block_rows)), dev,
                                  runs), passes)
    copy_ms = ms
    out = [{"case": "copy", "ms": ms, "ms_min": lo, "ms_max": hi}]
    print(f"{'copy':32s}: {ms:9.4f} ms/pass [{lo:.4f}-{hi:.4f}]")
    for V in vocabs:
        for label, S, dmod, skip in CASES:
            fn = chain(lambda t, V=V, S=S, dmod=dmod, skip=skip:
                       khist.onehot_hist(t, block_rows, V, S, dmod, skip)[0])
            ms, lo, hi = spread(time_runs(fn, dev, runs), passes)
            name = f"hist V={V:5d} {label}"
            row = {"case": name, "vocab": V, "sub_rows": S, "density_mod": dmod, "skip": skip,
                   "ms": ms, "ms_min": lo, "ms_max": hi, "added_ms": ms - copy_ms}
            line = (f"{name:32s}: {ms:9.4f} ms/pass [{lo:.4f}-{hi:.4f}]  "
                    f"{ms - copy_ms:+.4f} over copy")
            if dev.type == "cuda":
                row["bound_ms"], row["bound_by"] = bound(x, V)
                row["bound_share"] = row["bound_ms"] / ms
                row["mma_ms"] = onehot_mma_ms(x, block_rows, V, S, dmod, skip)
                line += (f"  bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
                         f"{row['bound_share']:.3f} of it; the TPU's one-hot products "
                         f"{row['mma_ms']:.4f} ms at peak bf16")
            print(line)
            out.append(row)
    return out
