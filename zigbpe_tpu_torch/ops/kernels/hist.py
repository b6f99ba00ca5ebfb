"""A blocked copy with two masked one-hot histograms: the CUDA kernel's
wrapper and its plain PyTorch twin.

Counterpart of the Pallas kernel ``kern`` of ``scripts/probe_hist.py``
(``pallas_call`` at :88); the kernel is ``csrc/hist.cu``, whose products
run on the tensor cores (``mma.sync`` bf16, f32 sums).

:func:`onehot_hist` takes ``x``, an int32 array of shape (rows, 128), and
returns ``(copy, hist)``: ``copy`` equals ``x``; ``hist`` is int32 of shape
(2 Vh, 128), Vh = ceil(vocab / 128). The tokens are read in blocks of
``rows_per_block`` R rows and subchunks of ``sub_rows`` S rows. A token
``t`` is a hit when ``t % density_mod == 0`` (``density_mod`` 0: no hits).
A token in [0, Vh * 128) counts in row ``t >> 7``, column ``t & 127`` of
the first half (rows [0, Vh)) when it is not a hit, of the second half
(rows [Vh, 2 Vh)) when it is; any other token counts nowhere, as the
Pallas compare ``(t >> 7) == hi_iota`` never matches it. With ``skip``, a
subchunk without a hit adds nothing to either half (the Pallas
``pl.when(nh > 0)``, probe_hist.py:72-77).

The TPU sums the one-hot products in f32 across its grid and casts to
int32 at the end (probe_hist.py:100); f32 counts are exact up to 2^24 per
bin. The card sums in f32 inside each block (at most R * 128 per bin) and
adds the blocks in int32 atomics. The two agree wherever no bin passes
2^24, and every input the tests use stays below that.

A CPU tensor runs the twin; a CUDA tensor launches the kernel or raises.
``onehot_hist.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import LAYOUT, _build

MAX_VOCAB = 36 * LAYOUT  # 2 Vh <= 72 columns: 9 tensor-core tiles of 8
MAX_SUB_ROWS = 96        # S * 128 int32 bins in 48 KB of shared memory


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


def onehot_hist(x: torch.Tensor, rows_per_block: int, vocab: int, sub_rows: int,
                density_mod: int, skip: bool):
    """The copy of ``x`` and its two masked histograms (module docstring)."""
    if x.device.type == "cpu":
        return onehot_hist_reference(x, rows_per_block, vocab, sub_rows, density_mod, skip)
    if not x.is_cuda:
        raise ValueError(f"onehot_hist runs on CUDA tensors (or its twin on CPU ones); got "
                         f"a tensor on {x.device}")
    _check(x, rows_per_block, vocab, sub_rows, density_mod)
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and 16-byte aligned")
    out = torch.empty_like(x)
    hist = torch.zeros((2 * vocab_rows(vocab), LAYOUT), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        rc = _library().zbpe_hist(x.data_ptr(), out.data_ptr(), x.shape[0], rows_per_block,
                                  sub_rows, vocab, density_mod, int(skip), hist.data_ptr(),
                                  torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"zbpe_hist launch failed: CUDA error {rc}")
    onehot_hist.launches += 1
    return out, hist


onehot_hist.launches = 0


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.library("hist")
    lib.zbpe_hist.restype = ctypes.c_int
    lib.zbpe_hist.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                              ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                              ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    return lib
