"""Blocked stream copies: the CUDA kernels' wrappers and their plain
PyTorch twins.

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
Each wrapper's ``launches`` counts its kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import LAYOUT, _build

DTYPES = {torch.int32: 4, torch.int16: 2}


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


def copy_blocks(x: torch.Tensor, rows_per_block: int) -> torch.Tensor:
    """Blocked copy of ``x`` in (rows_per_block, 128) blocks (module
    docstring)."""
    if x.device.type == "cpu":
        return copy_blocks_reference(x, rows_per_block)
    out, _ = _launch("zbpe_copy_blocks", x, rows_per_block)
    copy_blocks.launches += 1
    return out


def copy_carry(x: torch.Tensor, rows_per_block: int):
    """The blocked copy and the count of tokens >= 0 (module docstring)."""
    if x.device.type == "cpu":
        return copy_carry_reference(x, rows_per_block)
    out = _launch("zbpe_copy_carry", x, rows_per_block)
    copy_carry.launches += 1
    return out


def copy_peek(x: torch.Tensor, rows_per_block: int):
    """The blocked copy, the count and every block's look-ahead token
    (module docstring)."""
    if x.device.type == "cpu":
        return copy_peek_reference(x, rows_per_block)
    out = _launch("zbpe_copy_peek", x, rows_per_block)
    copy_peek.launches += 1
    return out


copy_blocks.launches = 0
copy_carry.launches = 0
copy_peek.launches = 0


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.library("copy")
    lib.zbpe_copy_blocks.restype = ctypes.c_int
    lib.zbpe_copy_blocks.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    for fn in (lib.zbpe_copy_carry, lib.zbpe_copy_peek):
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ]
    return lib


def _launch(entry: str, x: torch.Tensor, rows_per_block: int):
    """Launch ``entry`` on a CUDA tensor; returns (copy, count word or
    None for the plain copy)."""
    if not x.is_cuda:
        raise ValueError(
            f"the copy kernels run on CUDA tensors (or the twins on CPU ones); "
            f"got a tensor on {x.device}"
        )
    _check(x, rows_per_block, peek=entry == "zbpe_copy_peek")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and 16-byte aligned")
    lib = _library()
    out = torch.empty_like(x)
    args = [x.data_ptr(), out.data_ptr(), x.shape[0], rows_per_block, DTYPES[x.dtype]]
    acc = None
    if entry != "zbpe_copy_blocks":
        acc = torch.empty(1, dtype=torch.int32, device=x.device)
        args.append(acc.data_ptr())
    with torch.cuda.device(x.device):
        rc = getattr(lib, entry)(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")
    return out, acc
