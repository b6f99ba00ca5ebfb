"""Stream copies: the CUDA kernels' wrappers and their plain PyTorch
twins.

Counterparts of the Pallas copy kernels in ``scripts/probe_floor.py``
(``copy_kernel``) and ``scripts/probe_pipeline.py`` (``copy``,
``copy_carry``, ``copy_peek``, ``one_copy``); the kernels are
``csrc/copy.cu``. They measure the streaming floor under the merge pass.

Each takes ``x``, an int32 or int16 array of shape (rows, 128), and
``rows_per_block`` R (rows a multiple of R), and returns a new array equal
to ``x``:
- :func:`copy_blocks` returns the copy;
- :func:`copy_carry` returns ``(copy, count)``, ``count`` an int32[1] of the
  tokens ``x >= 0``;
- :func:`copy_peek` returns ``(copy, sum)``, ``sum`` an int32[1] of that count
  plus, for every block i of R rows, the look-ahead token
  ``x[min((i + 1) * R, rows - 8), 0]``, wrapping as int32 arithmetic does;
  rows and R are multiples of 8, as the Pallas 8-row look-ahead block needs.

A CPU tensor runs the twin; a CUDA tensor launches the kernel or raises.
Each wrapper's ``launches`` counts its kernel launches, each through
:class:`_build.Entry`.

:func:`copy_plan` states the launch geometry as the C entries compute it
(``copy_geometry`` in ``csrc/copy.cu``, whose constants of the same names
these are): a one-shot grid over the array's 16-byte vectors, R shaping no
tile, and copy_peek's look-ahead terms loaded by the grid's first threads,
one term a thread. The wrappers do not call it; the CPU tests replay it,
and ``chip_smoke.py`` holds it equal to the C side's (:func:`device_plan`)
on the card.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import LAYOUT, _build

DTYPES = {torch.int32: 4, torch.int16: 2}
THREADS = 256  # a block
VPT = 8        # 16-byte vectors a thread
GRID_X_MAX = 2**31 - 1
MODES = ("copy_blocks", "copy_carry", "copy_peek")  # the C side's mode numbers, in order


class CopyPlan(NamedTuple):
    n4: int     # 16-byte vectors of the array
    grid: int   # blocks; thread t of block b copies vectors b * THREADS * VPT + t + u * THREADS
    terms: int  # copy_peek's look-ahead terms, rows / R: global thread g loads term g


def copy_plan(rows: int, rows_per_block: int, elem: int, kernel: str) -> CopyPlan:
    """The launch of ``kernel`` (one of :data:`MODES`) on (rows, 128)
    integers of ``elem`` bytes. Refuses what the C entries refuse."""
    peek = kernel == "copy_peek"
    if (rows < 1 or rows_per_block < 1 or rows % rows_per_block or elem not in (4, 2)
            or peek and (rows % 8 or rows_per_block % 8)):
        raise ValueError(f"{kernel} takes no rows={rows} R={rows_per_block} elem={elem}")
    n4 = rows * LAYOUT * elem // 16
    grid = -(-n4 // (THREADS * VPT))
    if grid > GRID_X_MAX:
        raise ValueError(f"{n4} vectors need {grid} blocks, more than grid.x holds")
    return CopyPlan(n4, grid, rows // rows_per_block if peek else 0)


def _check(x: torch.Tensor, rows_per_block: int, peek: bool = False) -> None:
    if x.dtype not in DTYPES or x.dim() != 2 or x.shape[1] != LAYOUT:
        raise ValueError(f"x must be int32 or int16 (rows, {LAYOUT}), got {x.dtype} "
                         f"{tuple(x.shape)}")
    rows = x.shape[0]
    if rows_per_block < 1 or rows == 0 or rows % rows_per_block:
        raise ValueError(f"rows {rows} must be a positive multiple of rows_per_block "
                         f"{rows_per_block}")
    if peek and rows < 8:
        raise ValueError(f"copy_peek needs at least 8 rows, got {rows}")
    if peek and (rows % 8 or rows_per_block % 8):
        raise ValueError(f"copy_peek reads 8-row blocks: rows {rows} and rows_per_block "
                         f"{rows_per_block} must be multiples of 8")


def _wrap32(total: torch.Tensor) -> torch.Tensor:
    """An int64 total as the int32 it wraps to, shape [1]."""
    return (((total + 2**31) % 2**32) - 2**31).to(torch.int32).view(1)


def copy_blocks_reference(x: torch.Tensor, rows_per_block: int) -> torch.Tensor:
    """Plain twin of :func:`copy_blocks`."""
    _check(x, rows_per_block)
    return x.clone()


def copy_carry_reference(x: torch.Tensor, rows_per_block: int):
    """Plain twin of :func:`copy_carry`."""
    _check(x, rows_per_block)
    return x.clone(), _wrap32((x >= 0).sum(dtype=torch.int64))


def copy_peek_reference(x: torch.Tensor, rows_per_block: int):
    """Plain twin of :func:`copy_peek`: the look-ahead row
    ``min((i + 1) * R, rows - 8)`` heads the Pallas index map's 8-row block
    ``min((i + 1) * R // 8, rows // 8 - 1)``, as R and rows are multiples
    of 8."""
    _check(x, rows_per_block, peek=True)
    rows = x.shape[0]
    i = torch.arange(rows // rows_per_block, device=x.device)
    ahead = torch.clamp((i + 1) * rows_per_block, max=rows - 8)
    total = (x >= 0).sum(dtype=torch.int64) + x[ahead, 0].to(torch.int64).sum()
    return x.clone(), _wrap32(total)


P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_COPY_BLOCKS = _build.Entry("copy", "zbpe_copy_blocks", (P, P, LL, I, I))
_COPY_CARRY = _build.Entry("copy", "zbpe_copy_carry", (P, P, LL, I, I, P))
_COPY_PEEK = _build.Entry("copy", "zbpe_copy_peek", (P, P, LL, I, I, P))


def _prepare(x: torch.Tensor, rows_per_block: int, peek: bool = False) -> torch.Tensor:
    """Checks a CUDA tensor for the kernels; returns its output."""
    _check(x, rows_per_block, peek)
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and 16-byte aligned")
    return torch.empty_like(x)


def copy_blocks(x: torch.Tensor, rows_per_block: int) -> torch.Tensor:
    """Blocked copy of ``x`` in (rows_per_block, 128) blocks (module
    docstring)."""
    if not _build.on_card(x, "copy_blocks"):
        return copy_blocks_reference(x, rows_per_block)
    out = _prepare(x, rows_per_block)
    _COPY_BLOCKS(x.get_device(), x.data_ptr(), out.data_ptr(), x.shape[0], rows_per_block,
                 DTYPES[x.dtype])
    copy_blocks.launches += 1
    return out


def copy_carry(x: torch.Tensor, rows_per_block: int):
    """The blocked copy and the count of tokens >= 0 (module docstring)."""
    if not _build.on_card(x, "copy_carry"):
        return copy_carry_reference(x, rows_per_block)
    out = _prepare(x, rows_per_block)
    acc = torch.empty(1, dtype=torch.int32, device=x.device)  # zeroed by the C entry
    _COPY_CARRY(x.get_device(), x.data_ptr(), out.data_ptr(), x.shape[0], rows_per_block,
                DTYPES[x.dtype], acc.data_ptr())
    copy_carry.launches += 1
    return out, acc


def copy_peek(x: torch.Tensor, rows_per_block: int):
    """The blocked copy, the count and every block's look-ahead token
    (module docstring)."""
    if not _build.on_card(x, "copy_peek"):
        return copy_peek_reference(x, rows_per_block)
    out = _prepare(x, rows_per_block, peek=True)
    acc = torch.empty(1, dtype=torch.int32, device=x.device)  # zeroed by the C entry
    _COPY_PEEK(x.get_device(), x.data_ptr(), out.data_ptr(), x.shape[0], rows_per_block,
               DTYPES[x.dtype], acc.data_ptr())
    copy_peek.launches += 1
    return out, acc


copy_blocks.launches = 0
copy_carry.launches = 0
copy_peek.launches = 0


def device_plan(rows: int, rows_per_block: int, elem: int, kernel: str) -> CopyPlan:
    """The geometry the C entry of ``kernel`` launches for these arguments,
    as ``zbpe_copy_plan`` reports it."""
    fn = _build.library("copy").zbpe_copy_plan
    fn.restype = ctypes.c_int
    fn.argtypes = [LL, I, I, I, P]
    out = (LL * 3)()
    rc = fn(rows, rows_per_block, elem, MODES.index(kernel), out)
    if rc:
        raise ValueError(f"zbpe_copy_plan refused {kernel} rows={rows} R={rows_per_block} "
                         f"elem={elem}: CUDA error {rc}")
    return CopyPlan(*out)
