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
  a multiple of 16, the other of 8, K of 16. K is split over the blocks
  when the output has few tiles; the splits' partial tiles are folded in
  split order, so the result is the same from run to run;
- :func:`onehot_dot`: ``hi^T . lo`` of an int32 token column (n, 1), hi =
  ``(t >> 7) == iota(8)``, lo = ``(t & 127) == iota(128)``: the (8, 128)
  f32 count of the tokens in each bin of [0, 1024); n a multiple of 16.
  The kernel counts in integers (no products) and rounds each count to f32
  once, as the twin does, so it is exact at every n.

The TPU script catches a construct that does not lower and prints FAIL;
these catch nothing: a kernel that does not build raises, and one that is
wrong fails its twin check.

A CPU tensor runs the twin; a CUDA tensor launches the kernel or raises.
Each wrapper's ``launches`` counts its kernel launches, and each launches
through :class:`_build.Entry`.

:func:`transpose_plan`, :func:`column_plan`, :func:`onehot_plan` and
:func:`dot_plan` state the launch geometry of ``transpose``,
``rows_to_column``, ``onehot_dot`` and ``dot_tn`` as the C entries compute
it (``transpose_geometry``, ``column_geometry``, ``onehot_geometry`` and
``dot_geometry`` in ``csrc/lowering.cu``, whose constants of the same names
these are). The wrappers do not call them: the C side computes its
geometry from the shape and the pointers (and the card's SM count), so
that a call pays for no Python arithmetic. The CPU tests replay the plans
element by element, and ``chip_smoke.py`` holds them equal to the C side's
(:func:`device_plan`) on the card.

``onehot_dot`` and ``dot_tn`` keep one zeroed workspace per device
(:func:`_work`), which each call leaves zeroed: a call allocates nothing
and a CUDA graph can capture it after a first call on the device. Calls
on one device must not overlap in time.
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

ONEHOT_BINS = 1024      # onehot_dot: 8 hi rows x 128 lo columns
ONEHOT_THREADS = 1024   # a block, one bin a thread to clear and flush
ONEHOT_UNROLL = 4       # 16-byte vectors a thread a chunk
ONEHOT_CHUNK = ONEHOT_THREADS * ONEHOT_UNROLL * VEC  # 16384 tokens
ONEHOT_MAX_PER = 131071  # chunks a block: fewer than 2^31 tokens

DOT_THREADS = 256       # dot_tn: 8 warps, one k16 step of a stage each
DOT_WARPS = DOT_THREADS // 32
DOT_BP = 64             # a block's output tile: DOT_BP x DOT_BQ
DOT_BQ = 32
DOT_STAGES = 5          # the ring of stages in shared memory
DOT_MIN_SPLIT_STEPS = 16  # k16 steps a split takes at least
DOT_TICKETS = 256       # done tickets at the workspace's head
DOT_STAGE_ROWS = 16 * DOT_WARPS  # k rows a stage


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


class OnehotPlan(NamedTuple):
    chunks: int         # ONEHOT_CHUNK-token pieces of the tokens, the last ragged
    per: int            # chunks a block: block b counts chunks [b * per, b * per + per)
    grid: int           # ceil(chunks / per)
    sms: int            # SMs of the card
    blocks_per_sm: int  # the kernel's occupancy


class DotPlan(NamedTuple):
    tiles_p: int   # DOT_BP-row tiles of the output's P rows ...
    tiles_q: int   # ... by DOT_BQ-column tiles of its Q columns
    steps: int     # k16 steps, K / 16
    per: int       # k16 steps a split: split s takes [s * per, s * per + per)
    splits: int    # splits of K a tile; block b is tile b // splits, split b % splits
    grid: int      # tiles_p * tiles_q * splits
    sms: int       # SMs of the card
    ws_words: int  # 32-bit words of workspace the call uses: 0 with one split


def onehot_plan(n: int, ptr: int, sms: int, blocks_per_sm: int) -> OnehotPlan:
    """The launch of ``onehot_dot`` on ``n`` tokens at ``ptr`` on a card of
    ``sms`` SMs that holds ``blocks_per_sm`` of its blocks at once. Refuses
    what the C entry refuses."""
    if n < 1 or n % 16:
        raise ValueError(f"onehot_dot counts a positive multiple of 16 tokens, got {n}")
    if ptr % 16:
        raise ValueError(f"onehot_dot reads 16-byte vectors: {ptr:#x} is not 16-byte aligned")
    chunks = -(-n // ONEHOT_CHUNK)
    per = min(-(-chunks // min(chunks, sms * blocks_per_sm)), ONEHOT_MAX_PER)
    grid = -(-chunks // per)
    if grid > GRID_X_MAX:
        raise ValueError(f"{n} tokens need {grid} blocks, more than grid.x holds")
    return OnehotPlan(chunks, per, grid, sms, blocks_per_sm)


def dot_plan(K: int, P: int, Q: int, x_ptr: int, y_ptr: int, sms: int) -> DotPlan:
    """The launch of ``dot_tn``'s kernel on X (K, P) at ``x_ptr`` and Y
    (K, Q) at ``y_ptr`` (the wrapper's swap already made) on a card of
    ``sms`` SMs: enough splits of K a tile to fill min(sms, DOT_TICKETS)
    blocks, each at least DOT_MIN_SPLIT_STEPS k16 steps. Refuses what the C
    entry refuses."""
    if K < 1 or P < 1 or Q < 1 or K % 16 or P % 16 or Q % 8 or max(P, Q) > 2**31 - 1:
        raise ValueError(f"dot_tn's kernel takes K % 16, P % 16 and Q % 8 == 0, got "
                         f"({K}, {P}, {Q})")
    if x_ptr % 16 or y_ptr % 16:
        raise ValueError("dot_tn copies 16-byte chunks: both inputs must be 16-byte aligned")
    tiles_p, tiles_q = -(-P // DOT_BP), -(-Q // DOT_BQ)
    tiles = tiles_p * tiles_q
    if tiles > GRID_X_MAX:
        raise ValueError(f"({P}, {Q}) needs {tiles} tiles, more than grid.x holds")
    steps = K // 16
    splits = max(1, min(-(-min(sms, DOT_TICKETS) // tiles), steps // DOT_MIN_SPLIT_STEPS))
    per = -(-steps // splits)
    splits = -(-steps // per)
    grid = tiles * splits
    ws = DOT_TICKETS + grid * DOT_BP * DOT_BQ if splits > 1 else 0
    return DotPlan(tiles_p, tiles_q, steps, per, splits, grid, sms, ws)


def dot_work_words(sms: int) -> int:
    """The workspace ``dot_tn`` keeps on a card of ``sms`` SMs: the most any
    shape's :func:`dot_plan` uses (splits > 1 only when a tile count below
    min(sms, DOT_TICKETS) leaves the grid under twice that)."""
    return DOT_TICKETS + 2 * min(sms, DOT_TICKETS) * DOT_BP * DOT_BQ


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
_DOT_TN = _build.Entry("lowering", "zbpe_dot_tn", (P, P, P, LL, LL, LL, LL, LL, P, LL))
_ONEHOT_DOT = _build.Entry("lowering", "zbpe_onehot_dot", (P, P, LL, P))
_works: dict = {}  # (kernel, device index) -> its zeroed workspace


def _work(kernel: str, index: int) -> torch.Tensor:
    """The zeroed workspace of ``kernel`` ("onehot_dot": ONEHOT_BINS + 1
    int64, the counts and the done ticket; "dot_tn": dot_work_words int32,
    the tickets and the splits' partial tiles) on CUDA device ``index``,
    made at its first call there. Each launch leaves it zeroed."""
    work = _works.get((kernel, index))
    if work is None:
        dev = torch.device("cuda", index)
        if kernel == "onehot_dot":
            work = torch.zeros(ONEHOT_BINS + 1, dtype=torch.int64, device=dev)
        else:
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            work = torch.zeros(dot_work_words(sms), dtype=torch.int32, device=dev)
        _works[kernel, index] = work
    return work


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous and starting on 16 bytes (a copy when a view's
    offset puts it elsewhere)."""
    x = x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x


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
    a, b = _aligned(a), _aligned(b)
    (K, M), N = a.shape, b.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    if swap:  # D'[n][m] = sum_k b[k][n] a[k][m], stored at out[m][n]
        args = (b.data_ptr(), a.data_ptr(), out.data_ptr(), K, N, M, 1, N)
    else:
        args = (a.data_ptr(), b.data_ptr(), out.data_ptr(), K, M, N, N, 1)
    index = a.get_device()
    work = _work("dot_tn", index)
    _DOT_TN(index, *args, work.data_ptr(), work.numel())
    dot_tn.launches += 1
    return out


def onehot_dot(t: torch.Tensor) -> torch.Tensor:
    """``hi^T . lo`` of the token column ``t`` (n, 1): (8, 128) f32."""
    if t.device.type == "cpu":
        return onehot_dot_reference(t)
    _cuda(t, "onehot_dot")
    _check_tokens(t)
    t = _aligned(t)
    out = torch.empty((HI_ROWS, LAYOUT), dtype=torch.float32, device=t.device)
    index = t.get_device()
    _ONEHOT_DOT(index, t.data_ptr(), out.data_ptr(), t.shape[0],
                _work("onehot_dot", index).data_ptr())
    onehot_dot.launches += 1
    return out


KERNELS = (rows_to_column, transpose, iota_mod_add, dot_tn, onehot_dot)
for _fn in KERNELS:
    _fn.launches = 0


def device_plan(kernel, src_ptr: int, dst_ptr: int, *shape: int) -> tuple[int, ...]:
    """The geometry that the C entry of ``rows_to_column`` (shape: n),
    ``transpose`` (rows, cols), ``onehot_dot`` (n; src_ptr the tokens) or
    ``dot_tn``'s kernel (K, P, Q; src_ptr X, dst_ptr Y) launches for these
    pointers on the current device, as ``zbpe_lowering_plan`` reports it:
    the fields of :class:`ColumnPlan`, :class:`TransposePlan`,
    :class:`OnehotPlan` or :class:`DotPlan`."""
    fn = _build.library("lowering").zbpe_lowering_plan
    fn.restype = ctypes.c_int
    fn.argtypes = [I, P, P, LL, LL, LL, P]
    out = (LL * 8)()
    kind, fields = {rows_to_column: (0, ColumnPlan), transpose: (1, TransposePlan),
                    onehot_dot: (2, OnehotPlan), dot_tn: (3, DotPlan)}[kernel]
    a, b, c = (*shape, 0, 0)[:3]
    rc = fn(kind, src_ptr, dst_ptr, a, b, c, out)
    if rc:
        raise ValueError(f"zbpe_lowering_plan refused {kernel.__name__} {shape}: CUDA error {rc}")
    return tuple(out[:len(fields._fields)])
