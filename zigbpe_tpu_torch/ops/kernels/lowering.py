"""The lowering checks of the TPU build: the CUDA kernels' wrappers and
their plain PyTorch twins.

Counterparts of the Pallas kernels of ``scripts/probe_mosaic_ops.py``
(``try_kernel`` at :21, ``skinny`` at :77, ``onehot_dot`` at :97); the
kernels are ``csrc/lowering.cu``:
- :func:`rows_to_column`: (rows, cols) int32 -> (rows * cols, 1), read flat
  (both Pallas spellings of the reshape);
- :func:`transpose`: (rows, cols) int32 -> (cols, rows);
- :func:`iota_mod_add`: ``x + column index % m``, int32;
- :func:`dot_tn`: ``a^T . b`` of bf16 (K, M) and (K, N) in f32, on the
  tensor cores (the (256,128) product and the skinny (4096,8) one); M or N
  a multiple of 16, the other of 8, K of 16;
- :func:`onehot_dot`: ``hi^T . lo`` of an int32 token column (n, 1), hi =
  ``(t >> 7) == iota(8)``, lo = ``(t & 127) == iota(128)``: the (8, 128)
  f32 count of the tokens in each bin of [0, 1024); n a multiple of 16.

The TPU script catches a construct that does not lower and prints FAIL;
these catch nothing: a kernel that does not build raises, and one that is
wrong fails its twin check.

A CPU tensor runs the twin; a CUDA tensor launches the kernel or raises.
Each wrapper's ``launches`` counts its kernel launches, and each launches
through :class:`_build.Entry`.

:func:`transpose_plan` and :func:`column_plan` state the launch geometry of
``transpose`` and ``rows_to_column`` as the C entries compute it
(``transpose_geometry`` and ``column_geometry`` in ``csrc/lowering.cu``,
whose constants of the same names these are). The wrappers do not call
them: the C side computes its geometry from the shape and the pointers, so
that a call pays for no Python arithmetic. The CPU tests replay the plans
element by element, and ``chip_smoke.py`` holds them equal to the C side's
(:func:`device_plan`) on the card.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import LAYOUT, _build

HI_ROWS = 8  # the hi one-hot of onehot_dot: t >> 7 in [0, 8)

TILE = 64             # transpose: one TILE x TILE int32 tile a block ...
TILE_THREADS = 256    # ... of this many threads
VEC = 4               # int32 in a 16-byte vector
COLUMN_THREADS = 256  # rows_to_column: one element or vector a thread
GRID_X_MAX = 2**31 - 1


class TransposePlan(NamedTuple):
    tiles_c: int      # tiles along a row of x: block b is tile (b // tiles_c, b % tiles_c)
    grid: int         # blocks on grid.x, one a tile
    load_vec: bool    # x's rows start on 16 bytes: 16-byte loads, else scalars
    store_vec: bool   # the output's rows do: 16-byte stores, else scalars


class ColumnPlan(NamedTuple):
    head: int   # scalars first (all n when the pointers are not 16-byte aligned alike)
    vecs: int   # then 16-byte vectors
    tail: int   # then scalars
    grid: int   # blocks; thread i of the grid copies unit i of each part


def transpose_plan(rows: int, cols: int, src_ptr: int, dst_ptr: int) -> TransposePlan:
    """The launch of ``transpose`` on a (rows, cols) int32 array at
    ``src_ptr`` into ``dst_ptr``. Refuses an empty shape and one with more
    tiles than grid.x holds (offsets are 64-bit: nothing else limits it)."""
    if rows < 1 or cols < 1:
        raise ValueError(f"transpose needs a non-empty shape, got ({rows}, {cols})")
    tiles_c = -(-cols // TILE)
    grid = -(-rows // TILE) * tiles_c
    if grid > GRID_X_MAX:
        raise ValueError(f"({rows}, {cols}) needs {grid} tiles of {TILE} x {TILE}, more than "
                         f"grid.x holds ({GRID_X_MAX})")
    return TransposePlan(tiles_c, grid, src_ptr % 16 == 0 and cols % VEC == 0,
                         dst_ptr % 16 == 0 and rows % VEC == 0)


def column_plan(n: int, src_ptr: int, dst_ptr: int) -> ColumnPlan:
    """The launch of ``rows_to_column`` on ``n`` int32 at ``src_ptr`` into
    ``dst_ptr``. Refuses n < 1 and a part longer than grid.x's threads."""
    if n < 1:
        raise ValueError(f"rows_to_column copies at least one element, got {n}")
    head = n if (src_ptr - dst_ptr) % 16 else min(n, -src_ptr % 16 // 4)
    vecs = (n - head) // VEC
    tail = n - head - vecs * VEC
    grid = -(-max(head, vecs, tail) // COLUMN_THREADS)
    if grid > GRID_X_MAX:
        raise ValueError(f"{n} elements need {grid} blocks of {COLUMN_THREADS}, more than "
                         f"grid.x holds ({GRID_X_MAX})")
    return ColumnPlan(head, vecs, tail, grid)


def _check_int(x: torch.Tensor, dims: int = 2) -> None:
    if x.dtype != torch.int32 or x.dim() != dims or x.numel() == 0:
        raise ValueError(f"x must be a non-empty {dims}-d int32 tensor, got {x.dtype} "
                         f"{tuple(x.shape)}")


def _dot_layout(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Checks the shapes of ``dot_tn``; True when the kernel computes the
    transpose ``b^T . a`` (M below 16 rows)."""
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16 or a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"a and b must be 2-d bf16, got {a.dtype} {tuple(a.shape)} and "
                         f"{b.dtype} {tuple(b.shape)}")
    (K, M), (Kb, N) = a.shape, b.shape
    if K != Kb or K == 0 or K % 16:
        raise ValueError(f"a and b must share K, a positive multiple of 16: {K}, {Kb}")
    if M % 16 == 0 and M and N % 8 == 0 and N:
        return False
    if N % 16 == 0 and N and M % 8 == 0 and M:
        return True
    raise ValueError(f"dot_tn needs M or N a multiple of 16 and the other of 8, got M={M} "
                     f"N={N}")


def _check_tokens(t: torch.Tensor) -> None:
    if t.dtype != torch.int32 or t.dim() != 2 or t.shape[1] != 1 or t.shape[0] % 16 \
            or t.shape[0] == 0:
        raise ValueError(f"t must be an int32 (n, 1) column, n a positive multiple of 16, "
                         f"got {t.dtype} {tuple(t.shape)}")


def rows_to_column_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`rows_to_column`."""
    _check_int(x)
    return x.reshape(-1, 1).clone()


def transpose_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`transpose`."""
    _check_int(x)
    return x.t().contiguous()


def iota_mod_add_reference(x: torch.Tensor, m: int) -> torch.Tensor:
    """Plain twin of :func:`iota_mod_add`."""
    _check_int(x)
    if m < 1:
        raise ValueError(f"m must be >= 1, got {m}")
    return torch.arange(x.shape[1], dtype=torch.int32, device=x.device) % m + x


def dot_tn_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`dot_tn`: products of the bf16 values (exact in
    f32) summed over K in f32 by ``sum``."""
    _dot_layout(a, b)
    return (a.float()[:, :, None] * b.float()[:, None, :]).sum(0)


def onehot_dot_reference(t: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`onehot_dot`: a ``bincount`` of the tokens in
    [0, 8 * 128)."""
    _check_tokens(t)
    v = t.view(-1)
    v = v[(v >= 0) & (v < HI_ROWS * LAYOUT)]
    return torch.bincount(v.long(), minlength=HI_ROWS * LAYOUT).float().view(HI_ROWS, LAYOUT)


def _cuda(x: torch.Tensor, name: str) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name} runs on CUDA tensors (or its twin on CPU ones); got a "
                         f"tensor on {x.device}")


P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ROWS_TO_COLUMN = _build.Entry("lowering", "zbpe_rows_to_column", (P, P, LL))
_TRANSPOSE = _build.Entry("lowering", "zbpe_transpose", (P, P, LL, LL))
_IOTA_MOD_ADD = _build.Entry("lowering", "zbpe_iota_mod_add", (P, P, I, I, I))
_DOT_TN = _build.Entry("lowering", "zbpe_dot_tn", (P, P, P, I, I, I, I, I))
_ONEHOT_DOT = _build.Entry("lowering", "zbpe_onehot_dot", (P, P, I))


def _int_on_card(x: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor that ``name``'s kernel takes, False for a CPU
    tensor (its twin runs); raises on any other. One call, so that a
    launch pays for few Python calls."""
    if not x.is_cuda:
        if x.device.type == "cpu":
            return False
        _cuda(x, name)
    if x.dtype != torch.int32 or x.dim() != 2 or not x.numel():
        _check_int(x)
    return True


def rows_to_column(x: torch.Tensor) -> torch.Tensor:
    """``x`` (rows, cols) int32 read flat into one column (rows * cols, 1)."""
    if not _int_on_card(x, "rows_to_column"):
        return rows_to_column_reference(x)
    x = x.contiguous()
    n = x.numel()
    out = x.new_empty((n, 1))
    _ROWS_TO_COLUMN(x.get_device(), x.data_ptr(), out.data_ptr(), n)
    rows_to_column.launches += 1
    return out


def transpose(x: torch.Tensor) -> torch.Tensor:
    """``x`` (rows, cols) int32 transposed to (cols, rows)."""
    if not _int_on_card(x, "transpose"):
        return transpose_reference(x)
    x = x.contiguous()
    rows, cols = x.shape
    out = x.new_empty((cols, rows))
    _TRANSPOSE(x.get_device(), x.data_ptr(), out.data_ptr(), rows, cols)
    transpose.launches += 1
    return out


def iota_mod_add(x: torch.Tensor, m: int) -> torch.Tensor:
    """``x[r, c] + c % m`` (int32)."""
    if x.device.type == "cpu":
        return iota_mod_add_reference(x, m)
    _cuda(x, "iota_mod_add")
    _check_int(x)
    if m < 1:
        raise ValueError(f"m must be >= 1, got {m}")
    x = x.contiguous()
    out = torch.empty_like(x)
    _IOTA_MOD_ADD(x.get_device(), x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], m)
    iota_mod_add.launches += 1
    return out


def dot_tn(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a^T . b`` of bf16 (K, M) and (K, N), f32 (M, N), on the tensor
    cores; with M below 16 rows the kernel computes ``b^T . a`` and stores
    it transposed."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return dot_tn_reference(a, b)
    _cuda(a, "dot_tn")
    _cuda(b, "dot_tn")
    swap = _dot_layout(a, b)
    a, b = a.contiguous(), b.contiguous()
    (K, M), N = a.shape, b.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    if swap:  # D'[n][m] = sum_k b[k][n] a[k][m], stored at out[m][n]
        args = (b.data_ptr(), a.data_ptr(), out.data_ptr(), K, N, M, 1, N)
    else:
        args = (a.data_ptr(), b.data_ptr(), out.data_ptr(), K, M, N, N, 1)
    _DOT_TN(a.get_device(), *args)
    dot_tn.launches += 1
    return out


def onehot_dot(t: torch.Tensor) -> torch.Tensor:
    """``hi^T . lo`` of the token column ``t`` (n, 1): (8, 128) f32."""
    if t.device.type == "cpu":
        return onehot_dot_reference(t)
    _cuda(t, "onehot_dot")
    _check_tokens(t)
    t = t.contiguous()
    out = torch.empty((HI_ROWS, LAYOUT), dtype=torch.float32, device=t.device)
    _ONEHOT_DOT(t.get_device(), t.data_ptr(), out.data_ptr(), t.shape[0])
    onehot_dot.launches += 1
    return out


KERNELS = (rows_to_column, transpose, iota_mod_add, dot_tn, onehot_dot)
for _fn in KERNELS:
    _fn.launches = 0


def device_plan(kernel, src_ptr: int, dst_ptr: int, *shape: int) -> tuple[int, ...]:
    """The geometry that the C entry of ``rows_to_column`` (shape: n) or
    ``transpose`` (shape: rows, cols) launches for these pointers on the
    current device, as ``zbpe_lowering_plan`` reports it: the fields of
    :class:`ColumnPlan` or :class:`TransposePlan`."""
    fn = _build.library("lowering").zbpe_lowering_plan
    fn.restype = ctypes.c_int
    fn.argtypes = [I, P, P, LL, LL, P]
    out = (LL * 4)()
    kind = {rows_to_column: 0, transpose: 1}[kernel]
    rc = fn(kind, src_ptr, dst_ptr, shape[0], shape[-1], out)
    if rc:
        raise ValueError(f"zbpe_lowering_plan refused {kernel.__name__} {shape}: CUDA error {rc}")
    return tuple(out)
