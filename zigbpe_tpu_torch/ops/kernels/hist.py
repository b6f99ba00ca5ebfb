"""A blocked copy with two masked histograms kept exact inside the pass:
the CUDA kernel's wrapper and its plain PyTorch twin.

Counterpart of the Pallas kernel ``kern`` of ``scripts/probe_hist.py``
(``pallas_call`` at :88), which forms the counts as bf16 one-hot products;
the kernel is ``csrc/hist.cu``, which adds each kept token to a private
histogram in shared memory (a count needs no products).

:func:`onehot_hist` takes ``x``, an int32 array of shape (rows, 128), and
returns ``(copy, hist)``: ``copy`` equals ``x``; ``hist`` is int32 of shape
(2 Vh, 128), Vh = ceil(vocab / 128). The tokens are read in subchunks of
``sub_rows`` S rows, aligned from row 0; ``rows_per_block`` R (a multiple
of S dividing rows) is the TPU's tiling and changes nothing in the result.
A token ``t`` is a hit when ``t % density_mod == 0`` (``density_mod`` 0: no
hits). A token in [0, Vh * 128) counts in row ``t >> 7``, column ``t &
127`` of the first half (rows [0, Vh)) when it is not a hit, of the second
half (rows [Vh, 2 Vh)) when it is; any other token counts nowhere, as the
Pallas compare ``(t >> 7) == hi_iota`` never matches it. With ``skip``, a
subchunk without a hit adds nothing to either half (the Pallas
``pl.when(nh > 0)``, probe_hist.py:72-77).

The TPU sums the one-hot products in f32 across its grid and casts to
int32 at the end (probe_hist.py:100); f32 counts are exact up to 2^24 per
bin. The card counts in int32 throughout. The two agree wherever no bin
passes 2^24, and every input the tests use stays below that.

A CPU tensor runs the twin; a CUDA tensor launches the kernel or raises.
``onehot_hist.launches`` counts kernel launches, each through
:class:`_build.Entry`.

:func:`hist_plan` states the launch geometry as the C entry computes it
(``hist_geometry`` in ``csrc/hist.cu``, whose constants of the same names
these are): a persistent grid of blocks walking steps of the stream, a step
an S-row subchunk with ``skip`` and 32 rows without. The wrapper does not
call it; the CPU tests replay it, and ``chip_smoke.py`` holds it equal to
the C side's (:func:`device_plan`) on the card.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import LAYOUT, _build

MAX_VH = 36                  # a block's histogram, 2 * 36 * 128 int32, is 36,864 B
MAX_VOCAB = MAX_VH * LAYOUT  # 4608
MAX_SUB_ROWS = 96
THREADS = 256                # a block
ROW_VECS = LAYOUT // 4       # 16-byte vectors in a row of int32
PER_SMALL = 4                # vectors a thread a step: without skip, and with skip for S <= 32
PER_WIDE = 12                # with skip for 32 < S <= 96


class HistPlan(NamedTuple):
    vh: int             # ceil(vocab / 128)
    span4: int          # vectors a step: S * 32 with skip, THREADS * PER_SMALL without
    per: int            # vectors a thread holds in a step (the instantiation)
    steps: int          # steps of the stream; block b takes steps b, b + grid, ...
    smem: int           # bytes of a block's histogram
    sms: int            # SMs of the device
    blocks_per_sm: int  # the instantiation's occupancy at smem bytes
    grid: int           # min(steps, sms * blocks_per_sm)
    divc: int           # the hit test's multiplier, 2^64 // d + 1 mod 2^64 (0 for no hits)


def hit_multiplier(density_mod: int) -> int:
    """c of the kernel's hit test: ``t % d == 0`` exactly when ``(|t| * c)
    mod 2^64 <= c - 1`` (Lemire's divisibility test), for every int32 t;
    0 when ``density_mod`` is 0 (no hits)."""
    return ((2**64 - 1) // density_mod + 1) % 2**64 if density_mod else 0


def hist_plan(rows: int, rows_per_block: int, sub_rows: int, vocab: int, density_mod: int,
              skip: bool, sms: int, blocks_per_sm: int) -> HistPlan:
    """The launch of :func:`onehot_hist` on a card of ``sms`` SMs on which
    ``blocks_per_sm`` blocks of the chosen instantiation fit at once.
    Refuses what the C entry refuses."""
    if (rows < 1 or rows_per_block < 1 or sub_rows < 1 or rows % rows_per_block
            or rows_per_block % sub_rows or sub_rows > MAX_SUB_ROWS
            or not 1 <= vocab <= MAX_VOCAB or density_mod < 0):
        raise ValueError(f"zbpe_hist takes no rows={rows} R={rows_per_block} S={sub_rows} "
                         f"vocab={vocab} density_mod={density_mod}")
    vh = vocab_rows(vocab)
    span4 = sub_rows * ROW_VECS if skip else THREADS * PER_SMALL
    steps = -(-rows * ROW_VECS // span4)
    return HistPlan(vh, span4, PER_SMALL if span4 <= THREADS * PER_SMALL else PER_WIDE, steps,
                    2 * vh * LAYOUT * 4, sms, blocks_per_sm, min(steps, sms * blocks_per_sm),
                    hit_multiplier(density_mod))


def _check(x: torch.Tensor, rows_per_block: int, vocab: int, sub_rows: int,
           density_mod: int) -> None:
    if x.dtype != torch.int32 or x.dim() != 2 or x.shape[1] != LAYOUT:
        raise ValueError(f"x must be int32 (rows, {LAYOUT}), got {x.dtype} {tuple(x.shape)}")
    rows = x.shape[0]
    if rows_per_block < 1 or rows == 0 or rows % rows_per_block:
        raise ValueError(f"rows {rows} must be a positive multiple of rows_per_block "
                         f"{rows_per_block}")
    if not 1 <= sub_rows <= MAX_SUB_ROWS or rows_per_block % sub_rows:
        raise ValueError(f"sub_rows {sub_rows} must divide rows_per_block {rows_per_block} "
                         f"and be at most {MAX_SUB_ROWS}")
    if not 1 <= vocab <= MAX_VOCAB:
        raise ValueError(f"vocab must be in [1, {MAX_VOCAB}], got {vocab}")
    if density_mod < 0:
        raise ValueError(f"density_mod must be >= 0, got {density_mod}")


def vocab_rows(vocab: int) -> int:
    """Vh = ceil(vocab / 128): the rows of one half of the histogram."""
    return -(-vocab // LAYOUT)


def kept_subchunks(x: torch.Tensor, rows_per_block: int, sub_rows: int, density_mod: int,
                   skip: bool) -> torch.Tensor:
    """Bool per subchunk of ``sub_rows`` rows, in order: whether it enters
    the histogram (with ``skip``, only those with a hit)."""
    sub = x.reshape(-1, sub_rows * LAYOUT)
    if not skip:
        return torch.ones(sub.shape[0], dtype=torch.bool, device=x.device)
    if not density_mod:
        return torch.zeros(sub.shape[0], dtype=torch.bool, device=x.device)
    return (sub % density_mod == 0).any(1)


def onehot_hist_reference(x: torch.Tensor, rows_per_block: int, vocab: int, sub_rows: int,
                          density_mod: int, skip: bool):
    """Plain twin of :func:`onehot_hist`: ``x.clone()`` and one
    ``torch.bincount`` of ``half * Vh * 128 + t`` over the kept tokens."""
    _check(x, rows_per_block, vocab, sub_rows, density_mod)
    span = vocab_rows(vocab) * LAYOUT
    sub = x.reshape(-1, sub_rows * LAYOUT)
    hit = (sub % density_mod == 0) if density_mod else torch.zeros_like(sub, dtype=torch.bool)
    keep = (sub >= 0) & (sub < span)
    keep &= kept_subchunks(x, rows_per_block, sub_rows, density_mod, skip)[:, None]
    bins = (sub + hit.to(torch.int32) * span)[keep]
    hist = torch.bincount(bins.long(), minlength=2 * span).to(torch.int32)
    return x.clone(), hist.view(-1, LAYOUT)


P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_HIST = _build.Entry("hist", "zbpe_hist", (P, P, LL, I, I, I, I, I, P))


def onehot_hist(x: torch.Tensor, rows_per_block: int, vocab: int, sub_rows: int,
                density_mod: int, skip: bool):
    """The copy of ``x`` and its two masked histograms (module docstring)."""
    if not _build.on_card(x, "onehot_hist"):
        return onehot_hist_reference(x, rows_per_block, vocab, sub_rows, density_mod, skip)
    _check(x, rows_per_block, vocab, sub_rows, density_mod)
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and 16-byte aligned")
    out = torch.empty_like(x)
    hist = x.new_empty((2 * vocab_rows(vocab), LAYOUT))  # zeroed by the C entry
    _HIST(x.get_device(), x.data_ptr(), out.data_ptr(), x.shape[0], rows_per_block, sub_rows,
          vocab, density_mod, int(skip), hist.data_ptr())
    onehot_hist.launches += 1
    return out, hist


onehot_hist.launches = 0


def device_plan(rows: int, rows_per_block: int, sub_rows: int, vocab: int, density_mod: int,
                skip: bool) -> HistPlan:
    """The geometry the C entry launches for these arguments on the current
    device, as ``zbpe_hist_plan`` reports it."""
    fn = _build.library("hist").zbpe_hist_plan
    fn.restype = ctypes.c_int
    fn.argtypes = [LL, I, I, I, I, I, P]
    out = (LL * len(HistPlan._fields))()
    rc = fn(rows, rows_per_block, sub_rows, vocab, density_mod, int(skip), out)
    if rc:
        raise ValueError(f"zbpe_hist_plan refused rows={rows} R={rows_per_block} S={sub_rows} "
                         f"vocab={vocab}: CUDA error {rc}")
    return HistPlan(*out[:-1], out[-1] % 2**64)
