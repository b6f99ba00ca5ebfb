"""The merge kernel's op mix in int32 and packed int16: the CUDA kernel's
wrapper and its plain PyTorch twin.

Counterpart of the Pallas kernel ``opmix_kernel`` of
``scripts/probe_alu16.py`` (``pallas_call`` at :66); the kernel is
``csrc/opmix.cu``. :func:`opmix` takes ``x``, an int32 or int16 array of
shape (rows, 128), ``rows_per_block`` R (rows a multiple of R) and
``reps``, and returns a new array of ``x``'s type: on each block of R rows,
read flat, ``reps`` times

    nxt = the block shifted left by one slot, -1 at the block's last slot
    acc = where(acc == 101 & nxt == 32, 300, acc)
    acc = where(nxt < 0, acc, max(acc, nxt))

The -1 at each block's end is the Pallas ``shift_left1`` fill
(probe_alu16.py:41-47): no block reads the next block's head. On the card
``reps`` is one of :data:`REPS`, the probe's (the kernel is a template on
it); the twin takes any ``reps >= 0``.

A CPU tensor runs the twin; a CUDA tensor launches the kernel or raises.
``opmix.launches`` counts kernel launches, each through
:class:`_build.Entry`.
"""

from __future__ import annotations

import ctypes

import torch

from . import LAYOUT, _build

DTYPES = {torch.int32: 4, torch.int16: 2}
REPS = (0, 4, 16)
_OPMIX = _build.Entry("opmix", "zbpe_opmix", (ctypes.c_void_p, ctypes.c_void_p,
                                              ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                              ctypes.c_int))


def _check(x: torch.Tensor, rows_per_block: int) -> None:
    if x.dtype not in DTYPES or x.dim() != 2 or x.shape[1] != LAYOUT:
        raise ValueError(f"x must be int32 or int16 (rows, {LAYOUT}), got {x.dtype} "
                         f"{tuple(x.shape)}")
    rows = x.shape[0]
    if rows_per_block < 1 or rows == 0 or rows % rows_per_block:
        raise ValueError(f"rows {rows} must be a positive multiple of rows_per_block "
                         f"{rows_per_block}")


def opmix_reference(x: torch.Tensor, rows_per_block: int, reps: int) -> torch.Tensor:
    """Plain twin of :func:`opmix`: each block as one flat row, the shift a
    ``torch.cat`` with -1, then the two ``torch.where``s."""
    _check(x, rows_per_block)
    if reps < 0:
        raise ValueError(f"reps must be >= 0, got {reps}")
    acc = x.reshape(-1, rows_per_block * LAYOUT).clone()
    fill = torch.full((acc.shape[0], 1), -1, dtype=x.dtype, device=x.device)
    for _ in range(reps):
        nxt = torch.cat([acc[:, 1:], fill], dim=1)
        acc = torch.where((acc == 101) & (nxt == 32), 300, acc)
        acc = torch.where(nxt < 0, acc, torch.maximum(acc, nxt))
    return acc.reshape(x.shape)


def opmix(x: torch.Tensor, rows_per_block: int, reps: int) -> torch.Tensor:
    """The op mix of ``x`` over ``reps`` reps in blocks of ``rows_per_block``
    rows (module docstring)."""
    if not _build.on_card(x, "opmix"):
        return opmix_reference(x, rows_per_block, reps)
    _check(x, rows_per_block)
    if reps not in REPS:
        raise ValueError(f"reps must be one of {REPS} on the card, got {reps}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and 16-byte aligned")
    out = torch.empty_like(x)
    _OPMIX(x.get_device(), x.data_ptr(), out.data_ptr(), x.shape[0], rows_per_block,
           DTYPES[x.dtype], reps)
    opmix.launches += 1
    return out


opmix.launches = 0
