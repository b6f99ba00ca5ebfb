"""The launch geometry of the redesigned kernels of ``csrc/lowering.cu``
(the copies ``transpose`` and ``rows_to_column``, ``iota_mod_add``, and
``onehot_dot`` and ``dot_tn``) and the lean launch helper
(``ops/kernels/_build.Entry``), on the CPU.

A CUDA kernel cannot run here, so these tests replay its index map in
numpy: every block and thread of ``transpose_plan`` / ``column_plan``
writes what the kernel's loops write, through the same swizzled tile in
shared memory, and each element of the output must be written exactly
once, with its source element, by 16-byte vectors only where both ends are
16-byte aligned. The replay also checks the shared-memory banks of the
vector paths. ``iota_plan`` must write each element once, with its
column's ``c % m`` carried from one division a thread; ``onehot_plan``
must read each token once; ``dot_plan`` must
load and multiply each k row of each output tile once, through the ring of
stages, and its fold in split order must give the twin's result exactly on
integer values. ``chip_smoke.py`` holds the plans equal to the geometry the
C entries launch, on the card.
"""

from __future__ import annotations

import ctypes
import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from zigbpe_tpu_torch.ops.kernels import _build
from zigbpe_tpu_torch.ops.kernels import lowering as klow

REPO = Path(__file__).resolve().parents[1]
SHAPES = [(1, 1), (1, 5), (77, 1), (1000, 77), (32, 128), (4097, 129), (77, 128), (130, 64)]
OFFSETS = [0, 4, 8, 12]
BASE = 1 << 20  # a 16-byte-aligned address; offsets are added to it
T, W = klow.TILE, klow.VEC


def swz(r, c):
    """The tile's shared-memory column of element (r, c) (csrc/lowering.cu
    ``swz``)."""
    return (((c >> 2) ^ ((r >> 2) & 7)) << 2) | (c & 3)


def replay_transpose(rows, cols, src_ptr, dst_ptr):
    """What transpose_kernel writes, block by block: returns the number of
    writes to each output element and the source index each last received.
    Asserts the alignment of every vector access and the banks of the
    vector paths' shared-memory accesses."""
    plan = klow.transpose_plan(rows, cols, src_ptr, dst_ptr)
    assert plan.grid == plan.tiles_c * -(-rows // T)
    writes = np.zeros(rows * cols, np.int64)
    got = np.full(rows * cols, -1, np.int64)
    t = np.arange(klow.TILE_THREADS)
    steps = T * (T // W) // klow.TILE_THREADS
    for b in range(plan.grid):
        r0, c0 = b // plan.tiles_c * T, b % plan.tiles_c * T
        tile = np.full((T, T), -1, np.int64)  # source index held by each shared word
        if plan.load_vec:
            for s in range(steps):
                i = s * klow.TILE_THREADS + t
                r, c = i // (T // W), i % (T // W) * W
                ok = (r0 + r < rows) & (c0 + c < cols)
                g = (r0 + r) * cols + c0 + c
                assert (c0 + c[ok] + W <= cols).all()  # a whole vector inside the row
                assert ((src_ptr + 4 * g[ok]) % 16 == 0).all()
                phys = swz(r, c)
                for q in range(0, klow.TILE_THREADS, 8):  # 8 lanes, 128 bytes: no conflict
                    lanes = slice(q, q + 8)
                    assert len(set((phys[lanes] // W % 8).tolist())) == 8
                for j in range(W):
                    tile[r[ok], phys[ok] + j] = g[ok] + j
        else:
            for i in range(0, T * T, klow.TILE_THREADS):
                r, c = (i + t) // T, (i + t) % T
                ok = (r0 + r < rows) & (c0 + c < cols)
                tile[r[ok], swz(r[ok], c[ok])] = ((r0 + r) * cols + c0 + c)[ok]
        if plan.store_vec:
            lane, warp = t & 31, t >> 5
            for s in range(steps):
                task = s * (klow.TILE_THREADS // 32) + warp
                c = (task >> 1) * W + (lane >> 3)
                r = ((task & 1) * 8 + (lane & 7)) * W
                ok = (c0 + c < cols) & (r0 + r < rows)
                o = (c0 + c) * rows + r0 + r
                assert (r0 + r[ok] + W <= rows).all()
                assert ((dst_ptr + 4 * o[ok]) % 16 == 0).all()
                for j in range(W):
                    phys = (r + j) * T + swz(r + j, c)
                    for w in range(klow.TILE_THREADS // 32):  # a warp reads 32 banks
                        assert len(set((phys[32 * w:32 * w + 32] % 32).tolist())) == 32
                    src = tile[r[ok] + j, swz(r[ok] + j, c[ok])]
                    assert (src >= 0).all()  # loaded by this block
                    np.add.at(writes, o[ok] + j, 1)
                    got[o[ok] + j] = src
        else:
            for i in range(0, T * T, klow.TILE_THREADS):
                c, r = (i + t) // T, (i + t) % T
                ok = (c0 + c < cols) & (r0 + r < rows)
                o = ((c0 + c) * rows + r0 + r)[ok]
                src = tile[r[ok], swz(r[ok], c[ok])]
                assert (src >= 0).all()
                np.add.at(writes, o, 1)
                got[o] = src
    return plan, writes, got


def replay_column(n, src_ptr, dst_ptr):
    """What column_kernel writes: thread i of the grid copies unit i of the
    head (scalars), of the vectors and of the tail. Returns the plan and the
    number of writes to each output element (each reads the element of the
    same index); asserts the alignment of every vector."""
    plan = klow.column_plan(n, src_ptr, dst_ptr)
    assert plan.head + W * plan.vecs + plan.tail == n
    i = np.arange(plan.grid * klow.COLUMN_THREADS)
    writes = np.zeros(n, np.int64)
    for count, start, width in ((plan.head, 0, 1), (plan.vecs, plan.head, W),
                                (plan.tail, plan.head + W * plan.vecs, 1)):
        first = start + width * i[i < count]
        if width == W:
            assert ((src_ptr + 4 * first) % 16 == 0).all()
            assert ((dst_ptr + 4 * first) % 16 == 0).all()
        for j in range(width):
            np.add.at(writes, first + j, 1)
    return plan, writes


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("src_off", OFFSETS)
@pytest.mark.parametrize("dst_off", [0, 8])
def test_transpose_tiles_cover_every_element_once(shape, src_off, dst_off):
    rows, cols = shape
    plan, writes, got = replay_transpose(rows, cols, BASE + src_off, 2 * BASE + dst_off)
    assert (writes == 1).all()
    r, c = np.divmod(np.arange(rows * cols), cols)  # source (r, c) ...
    np.testing.assert_array_equal(got[c * rows + r], r * cols + c)  # ... lands at (c, r)
    assert plan.load_vec == (src_off == 0 and cols % 4 == 0)
    assert plan.store_vec == (dst_off == 0 and rows % 4 == 0)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("src_off", OFFSETS)
@pytest.mark.parametrize("dst_off", OFFSETS)
def test_column_covers_every_element_once(shape, src_off, dst_off):
    n = shape[0] * shape[1]
    plan, writes = replay_column(n, BASE + src_off, 2 * BASE + dst_off)
    assert (writes == 1).all()
    if src_off == dst_off:  # aligned alike: a scalar head to 16 bytes, then vectors
        assert plan.head == min(n, (16 - src_off) % 16 // 4) and plan.tail < 4
    else:  # else every element takes the scalar stride
        assert (plan.head, plan.vecs, plan.tail) == (n, 0, 0)


@pytest.mark.parametrize("n,src_off,grid", [
    (4096, 0, 4),                 # the script's (32, 128): 1024 vectors
    (1 << 25, 0, 1 << 15),        # 2^25 int32: 2^23 vectors, one a thread
    (1 << 25, 4, 1 << 17),        # ... 4 bytes off: 2^25 scalars
    (5, 0, 1),
])
def test_column_grid(n, src_off, grid):
    assert klow.column_plan(n, src_off, 0).grid == grid


@pytest.mark.parametrize("shape", [(1 << 25, 1), (1, 1 << 25), (1 << 22, 1), (262144, 128),
                                   ((1 << 31) + 1, 1)])
def test_plans_take_tall_wide_and_large_shapes(shape):
    rows, cols = shape
    plan = klow.transpose_plan(rows, cols, 0, 0)
    assert plan.grid == -(-rows // 64) * -(-cols // 64) <= klow.GRID_X_MAX
    n = rows * cols  # up to 2^31 + 1 elements: more than a C int holds
    for src_off in (0, 4):
        col = klow.column_plan(n, src_off, 0)
        assert col.head + 4 * col.vecs + col.tail == n and col.grid <= klow.GRID_X_MAX


@pytest.mark.parametrize("call,match", [
    (lambda: klow.transpose_plan(64 << 31, 1, 0, 0), "more than grid.x holds"),
    (lambda: klow.transpose_plan(1 << 40, 1 << 40, 0, 0), "more than grid.x holds"),
    (lambda: klow.transpose_plan(0, 5, 0, 0), "non-empty"),
    (lambda: klow.column_plan(0, 0, 0), "at least one"),
    (lambda: klow.column_plan(1 << 40, 4, 0), "more than grid.x holds"),  # scalars
    (lambda: klow.iota_plan(0, 5, 0, 0, 132), "non-empty"),
    (lambda: klow.iota_plan(1, (1 << 40) + 1, 0, 0, 132), "more than grid.x holds"),
])
def test_plans_refuse_what_the_kernels_cannot_index(call, match):
    with pytest.raises(ValueError, match=match):
        call()


def test_plan_constants_match_the_kernel_source():
    """The plans' constants are csrc/lowering.cu's, and the launch entries'
    argument types carry n, rows, cols, K, P and Q as 64-bit integers
    (iota_mod_add's rows and cols too)."""
    src = (REPO / "zigbpe_tpu_torch" / "csrc" / "lowering.cu").read_text()
    cu = {m[0]: int(m[1]) for m in re.findall(r"constexpr (?:int|long long) (\w+) = (\d+);", src)}
    for name in ("TILE", "TILE_THREADS", "VEC", "COLUMN_THREADS", "GRID_X_MAX", "GRID_Y_MAX",
                 "IOTA_THREADS", "IOTA_UNROLL", "ONEHOT_BINS",
                 "ONEHOT_THREADS", "ONEHOT_UNROLL", "ONEHOT_MAX_PER", "DOT_THREADS", "DOT_BP",
                 "DOT_BQ", "DOT_STAGES", "DOT_MIN_SPLIT_STEPS", "DOT_TICKETS"):
        assert cu[name] == getattr(klow, name), name
    for line in ("constexpr int ONEHOT_CHUNK = ONEHOT_THREADS * ONEHOT_UNROLL * VEC;",
                 "constexpr int DOT_WARPS = DOT_THREADS / 32;",
                 "constexpr int DOT_STAGE_ROWS = 16 * DOT_WARPS;",
                 "constexpr int X_PITCH = DOT_BP * 2 + 16;",
                 "constexpr int Y_PITCH = DOT_BQ * 2 + 16;",
                 "constexpr int RED_PITCH = DOT_BQ + 8;"):
        assert line in src, line
    assert "int zbpe_rows_to_column(const int* src, int* dst, long long n, void* stream)" in src
    assert ("int zbpe_transpose(const int* src, int* dst, long long rows, long long cols, "
            "void* stream)") in src
    assert ("int zbpe_dot_tn(const void* X, const void* Y, float* out, long long K, long long P, "
            "long long Q,\n                long long sp, long long sq, int* ws, long long "
            "ws_words, void* stream)") in src
    assert ("int zbpe_onehot_dot(const int* t, float* out, long long n, unsigned long long* ws,"
            "\n                    void* stream)") in src
    assert ("int zbpe_iota_mod_add(const int* src, int* dst, long long rows, long long cols, "
            "int m,\n                      void* stream)") in src
    assert "iota_mod_kernel(const int* __restrict__ src, int* __restrict__ dst, long long rows," \
        "\n                long long units, int m)" in src
    assert klow._ROWS_TO_COLUMN.argtypes[2] is ctypes.c_longlong
    assert klow._TRANSPOSE.argtypes[2:] == (ctypes.c_longlong, ctypes.c_longlong)
    assert klow._ONEHOT_DOT.argtypes == (klow.P, klow.P, ctypes.c_longlong, klow.P)
    assert klow._IOTA_MOD_ADD.argtypes == (klow.P, klow.P, ctypes.c_longlong, ctypes.c_longlong,
                                           ctypes.c_int)
    assert klow._DOT_TN.argtypes == (klow.P, klow.P, klow.P, *[ctypes.c_longlong] * 5, klow.P,
                                     ctypes.c_longlong)


# ----------------------------------------------------------- iota_mod_add

IOTA_SHAPES = [(1, 1), (7, 5), (32, 128), (64, 1000)]


def replay_iota(rows, cols, src_ptr, dst_ptr, m, sms):
    """What iota_mod_kernel writes, thread by thread of every block: thread
    (x, y) of block (i, k) takes unit j = i * bx + x (a 16-byte vector of 4
    columns, or one column), computes its first column's c % m with one
    division and the next columns' by a wrap, and walks the rows k * by + y,
    grid_y * by apart, IOTA_UNROLL at a time. Returns the plan, the number
    of writes to each element, what each last had added and the most rows
    a thread took; asserts the alignment of every vector."""
    plan = klow.iota_plan(rows, cols, src_ptr, dst_ptr, sms)
    w = W if plan.vec else 1
    assert plan.units * w == cols and plan.bx * plan.by <= klow.IOTA_THREADS
    writes = np.zeros(rows * cols, np.int64)
    added = np.full(rows * cols, -1, np.int64)
    y, x = np.divmod(np.arange(plan.bx * plan.by), plan.bx)
    stride, end = plan.grid_y * plan.by * plan.units, rows * plan.units
    most = 0
    for i in range(plan.grid_x):
        j = i * plan.bx + x
        live = j < plan.units
        cm = [(w * j[live]) % m]  # the thread's one division
        for _ in range(1, w):
            cm.append(np.where(cm[-1] + 1 == m, 0, cm[-1] + 1))
        for k in range(plan.grid_y):
            base = (k * plan.by + y[live]) * plan.units + j[live]  # in units
            taken = np.zeros(base.size, np.int64)
            while (base < end).any():  # the loop's trip; IOTA_UNROLL rows each
                for u in range(klow.IOTA_UNROLL):
                    off = base + u * stride
                    ok = off < end
                    if plan.vec:
                        assert ((src_ptr + 16 * off[ok]) % 16 == 0).all()
                        assert ((dst_ptr + 16 * off[ok]) % 16 == 0).all()
                    for c in range(w):
                        np.add.at(writes, w * off[ok] + c, 1)
                        added[w * off[ok] + c] = cm[c][ok]
                    taken += ok
                base = base + klow.IOTA_UNROLL * stride
            most = max(most, int(taken.max(initial=0)))
    return plan, writes, added, most


@pytest.mark.parametrize("shape", IOTA_SHAPES)
@pytest.mark.parametrize("src_off", [0, 4])  # 4: a view whose data starts 4 bytes off 16
@pytest.mark.parametrize("m", [1, 3, 4, 7, 1000])
@pytest.mark.parametrize("dst_off,grid_y_max", [(0, klow.GRID_Y_MAX), (8, klow.GRID_Y_MAX),
                                                (0, 2)])
@pytest.mark.parametrize("sms", [132, 4])  # the H100's, and a small card
def test_iota_covers_every_element_once(monkeypatch, shape, src_off, m, dst_off, grid_y_max,
                                        sms):
    """Each element written once, with its column's c % m; grid.y's limit
    lowered to 2 row blocks makes the threads walk past their first trip.
    An array that IOTA_UNROLL rows a thread would leave under IOTA_UNROLL
    blocks an SM takes one row a thread."""
    monkeypatch.setattr(klow, "GRID_Y_MAX", grid_y_max)
    rows, cols = shape
    plan, writes, added, most = replay_iota(rows, cols, BASE + src_off, 2 * BASE + dst_off, m,
                                            sms)
    assert (writes == 1).all()
    np.testing.assert_array_equal(added, np.arange(rows * cols) % cols % m)
    assert plan.vec == (src_off == 0 and dst_off == 0 and cols % 4 == 0)
    assert plan.grid_y <= grid_y_max
    groups = -(-rows // plan.by)
    spread = plan.grid_x * groups < sms * klow.IOTA_UNROLL
    if plan.grid_y < grid_y_max:  # one trip: the grid is one-shot
        assert most <= (1 if spread else klow.IOTA_UNROLL)


@pytest.mark.parametrize("shape,want", [
    ((262144, 128), klow.IotaPlan(True, 32, 32, 8, 1, 8192, 132)),   # 2^25: 4 rows a thread
    ((131072, 32769), klow.IotaPlan(False, 32769, 256, 1, 129, 32768, 132)),  # past 2^32
    ((32768, 131076), klow.IotaPlan(True, 32769, 256, 1, 129, 8192, 132)),    # ... vector
    ((1 << 28, 1), klow.IotaPlan(False, 1, 1, 256, 1, 65535, 132)),  # grid.y's limit: a walk
    ((32, 128), klow.IotaPlan(True, 32, 32, 8, 1, 4, 132)),  # the script's: a row a thread
])
def test_iota_plan_covers_large_shapes_exactly(shape, want):
    """By arithmetic: the plan's units cover each row once, its row offsets
    [0, grid_y * by) cover the rows once, each thread takes IOTA_UNROLL rows
    (one at the script's (32, 128), spread over the card) unless grid.y's
    limit makes it walk on; past 2^32 elements the last element's index
    needs 64 bits."""
    rows, cols = shape
    plan = klow.iota_plan(rows, cols, BASE, 2 * BASE, 132)
    assert plan == want
    w = W if plan.vec else 1
    assert (plan.grid_x - 1) * plan.bx < plan.units <= plan.grid_x * plan.bx
    step = plan.grid_y * plan.by
    walked = [len(range(o, rows, step)) for o in range(step)]
    assert sum(walked) == rows and sum(walked) * plan.units * w == rows * cols
    assert max(walked) <= (klow.IOTA_UNROLL if rows * cols >= 1 << 20 else 1) \
        or plan.grid_y == klow.GRID_Y_MAX
    if rows * cols > 2**32:
        assert (rows * cols) % 2**32 == 131072  # what a 32-bit n kept


# ------------------------------------------------------------- onehot_dot

SM_CASES = [(132, 2), (132, 1), (4, 1)]  # (sms, blocks_per_sm): the H100's, and a small card


def replay_onehot(n, sms, blocks_per_sm):
    """The 16-byte vectors onehot_kernel's threads load, block by block:
    returns the plan and the number of loads of each vector."""
    plan = klow.onehot_plan(n, BASE, sms, blocks_per_sm)
    n4, T, U = n // W, klow.ONEHOT_THREADS, klow.ONEHOT_UNROLL
    share = plan.per * T * U
    loads = np.zeros(n4, np.int64)
    t, k = np.arange(T), np.arange(U)
    for b in range(plan.grid):
        v0, v1 = b * share, min(b * share + share, n4)
        assert v1 - v0 <= (2**31 - 1) // W  # a block's int32 bins cannot overflow
        base = v0 + t[None, :] + T * U * np.arange(-(-(v1 - v0) // (T * U)))[:, None]
        alive = base < v1  # the thread's loop runs this step
        vec = base[:, None, :] + T * k[None, :, None]
        live = alive[:, None, :] & (vec < v1)
        np.add.at(loads, vec[live], 1)
    return plan, loads


@pytest.mark.parametrize("n", [16, 4096, 4112, 3 * 16384 + 16, (1 << 20) + 48, 1 << 25])
@pytest.mark.parametrize("sms,blocks_per_sm", SM_CASES)
def test_onehot_reads_every_token_once(n, sms, blocks_per_sm):
    plan, loads = replay_onehot(n, sms, blocks_per_sm)
    assert (loads == 1).all()
    assert plan.grid <= sms * blocks_per_sm and plan.grid * plan.per >= plan.chunks
    assert (plan.grid - 1) * plan.per < plan.chunks  # no block without a chunk
    if n <= klow.ONEHOT_CHUNK:
        assert plan.grid == 1  # the script's 4096 tokens: a lone block writes its bins


@pytest.mark.parametrize("n", [(1 << 32) + 16, 1 << 34, (1 << 40) + 16])
def test_onehot_plan_takes_counts_past_32_bits(n):
    plan = klow.onehot_plan(n, BASE, 132, 2)
    assert plan.chunks == -(-n // klow.ONEHOT_CHUNK) and plan.grid * plan.per >= plan.chunks
    assert plan.per * klow.ONEHOT_CHUNK < 2**31  # a block's int32 bins cannot overflow
    assert plan.grid <= klow.GRID_X_MAX


def test_onehot_counts_in_integers_then_rounds_once():
    """The kernel's arithmetic on the fault column (2^24 zeros, then 2^20
    groups of one 0 and fifteen 1s): int32 bins a block, 64-bit sums over
    the blocks, one rounding to f32. Bin (0, 0) is 2^24 + 2^20, as the twin
    says; an f32 count stops at 2^24."""
    tail = np.ones((1 << 20, 16), np.int32)
    tail[:, 0] = 0
    col = np.concatenate([np.zeros(1 << 24, np.int32), tail.ravel()])
    plan = klow.onehot_plan(col.size, BASE, 132, 2)
    share = plan.per * klow.ONEHOT_CHUNK
    total = np.zeros(klow.ONEHOT_BINS, np.uint64)
    for b in range(plan.grid):
        part = col[b * share:(b + 1) * share]
        bins = np.bincount(part[(part >= 0) & (part < klow.ONEHOT_BINS)],
                           minlength=klow.ONEHOT_BINS)
        assert bins.max() < 2**31
        total += bins.astype(np.uint64)
    got = total.astype(np.float32).reshape(8, 128)
    want = klow.onehot_dot_reference(torch.from_numpy(col).view(-1, 1)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] == (1 << 24) + (1 << 20)
    assert np.float32(2**24) + np.float32(1) == np.float32(2**24)  # what f32 counts did


@pytest.mark.parametrize("call,match", [
    (lambda: klow.onehot_plan(0, BASE, 132, 2), "multiple of 16"),
    (lambda: klow.onehot_plan(4104, BASE, 132, 2), "multiple of 16"),
    (lambda: klow.onehot_plan(4096, BASE + 4, 132, 2), "16-byte aligned"),
    (lambda: klow.dot_plan(24, 128, 128, BASE, BASE, 132), "K % 16"),
    (lambda: klow.dot_plan(256, 24, 8, BASE, BASE, 132), "P % 16"),
    (lambda: klow.dot_plan(256, 16, 12, BASE, BASE, 132), "Q % 8"),
    (lambda: klow.dot_plan(256, 128, 128, BASE + 8, BASE, 132), "16-byte aligned"),
])
def test_product_plans_refuse_what_the_kernels_do_not_take(call, match):
    with pytest.raises(ValueError, match=match):
        call()


# ----------------------------------------------------------------- dot_tn

X_PITCH, Y_PITCH = klow.DOT_BP * 2 + 16, klow.DOT_BQ * 2 + 16
DOT_SHAPES = [(256, 128, 128), (4096, 8, 128), (4112, 48, 24), (272, 8, 208), (16, 16, 8),
              (512, 512, 256), (16 * 1000, 128, 8)]  # (K, M, N) of a and b


def kernel_shape(K, M, N):
    """(K, P, Q) of the kernel's X and Y: the wrapper swaps when M < 16."""
    return (K, N, M) if M % 16 else (K, M, N)


@functools.lru_cache(maxsize=None)
def stage_loader_covers(rows, xc, yc):
    """The loader of a stage (thread t copies 16-byte chunk t % 8 of stage
    rows t / 8 + 32 j, of X when the chunk is below xc, of Y below yc)
    copies each chunk of the stage's first ``rows`` rows exactly once."""
    t = np.arange(klow.DOT_THREADS)
    lc, lr, step = t & 7, t >> 3, klow.DOT_THREADS // 8
    for width in (xc, yc):
        got = np.zeros((klow.DOT_STAGE_ROWS, 8), np.int64)
        for j in range(klow.DOT_STAGE_ROWS // step):
            r = lr + step * j
            ok = (r < rows) & (lc < width)
            np.add.at(got, (r[ok], lc[ok]), 1)
        if not ((got[:rows, :width] == 1).all() and got.sum() == rows * width):
            return False
    return True


def replay_dot(K, P, Q, sms):
    """dot_tn_kernel's loads and products, block by block: returns the plan,
    the number of times each k16 step of each tile is loaded and multiplied
    (both must be 1) and each output element's tile count. Asserts the
    ring's order: the group a wait completes holds the stage it computes,
    and a load goes into the slot whose stage every warp has finished."""
    plan = klow.dot_plan(K, P, Q, BASE, 2 * BASE, sms)
    tiles = plan.tiles_p * plan.tiles_q
    assert plan.grid == tiles * plan.splits
    loaded = np.zeros((tiles, plan.steps), np.int64)
    used = np.zeros((tiles, plan.steps), np.int64)
    owner = np.zeros((P, Q), np.int64)
    S, Wp = klow.DOT_STAGES, klow.DOT_WARPS
    for b in range(plan.grid):
        tile, split = divmod(b, plan.splits)
        p0, q0 = tile // plan.tiles_q * klow.DOT_BP, tile % plan.tiles_q * klow.DOT_BQ
        np_, nq = min(klow.DOT_BP, P - p0), min(klow.DOT_BQ, Q - q0)
        assert np_ % 16 == 0 and nq % 8 == 0 and np_ > 0 and nq > 0
        if split == 0:
            owner[p0:p0 + np_, q0:q0 + nq] += 1
        s0 = plan.per * split
        nsteps = min(plan.per, plan.steps - s0)
        assert nsteps >= 1
        stages = -(-nsteps // Wp)
        groups = [st if st < stages else None for st in range(S - 1)]  # the prologue's
        slot_stage = {st % S: st for st in range(min(S - 1, stages))}
        for st in range(stages):
            done = len(groups) - (S - 2)  # wait_group S - 2: all but the last S - 2 groups
            assert st in groups[:done]
            nxt = st + S - 1
            if nxt < stages:
                assert slot_stage.get(nxt % S, -1) < st  # its stage was computed before the barrier
                slot_stage[nxt % S] = nxt
            groups.append(nxt if nxt < stages else None)
            rows = min(klow.DOT_STAGE_ROWS, (nsteps - st * Wp) * 16)
            assert stage_loader_covers(rows, np_ // 8, nq // 8)
            loaded[tile, s0 + st * Wp:s0 + st * Wp + rows // 16] += 1
            assert slot_stage[st % S] == st
            for w in range(Wp):
                if st * Wp + w < nsteps:
                    assert 16 * w + 16 <= rows  # the warp's rows are in the stage
                    used[tile, s0 + st * Wp + w] += 1
    return plan, loaded, used, owner


@pytest.mark.parametrize("shape", DOT_SHAPES)
@pytest.mark.parametrize("sms", [132, 8])
def test_dot_covers_each_k_row_of_each_tile_once(shape, sms):
    K, P, Q = kernel_shape(*shape)
    plan, loaded, used, owner = replay_dot(K, P, Q, sms)
    assert (loaded == 1).all() and (used == 1).all() and (owner == 1).all()
    assert plan.splits == 1 or plan.per >= klow.DOT_MIN_SPLIT_STEPS
    assert plan.splits == 1 or plan.tiles_p * plan.tiles_q < min(sms, klow.DOT_TICKETS)
    assert plan.ws_words <= klow.dot_work_words(sms)


def test_dot_plan_splits_the_skinny_products_over_the_card():
    """The script's (256,128)^T(256,128) runs as 8 tiles, no split; the
    skinny products as 2 tiles split over the card's 132 SMs."""
    assert klow.dot_plan(256, 128, 128, BASE, BASE, 132)[:6] == (2, 4, 16, 16, 1, 8)
    assert klow.dot_plan(4096, 128, 8, BASE, BASE, 132)[:6] == (2, 1, 256, 16, 16, 32)
    assert klow.dot_plan(1 << 20, 128, 8, BASE, BASE, 132)[:6] == (2, 1, 65536, 993, 66, 132)
    big = klow.dot_plan(1 << 33, 128, 8, BASE, BASE, 132)  # K past 32 bits
    assert big.steps == 1 << 29 and big.splits * big.per >= big.steps


@pytest.mark.parametrize("which", ["A", "B x4", "B x2"])
def test_dot_ldmatrix_rows_fall_on_distinct_banks(which):
    """The 8 rows an ldmatrix phase reads (8 lanes, 16 bytes each) sit on
    8 distinct 16-byte bank groups of the padded stage rows."""
    lane = np.arange(32)
    if which == "A":
        r, c, pitch = (lane & 7) + (lane >> 4) * 8, ((lane >> 3) & 1) * 8, X_PITCH
    else:
        r, c, pitch = (lane & 7) + ((lane >> 3) & 1) * 8, (lane >> 4) * 8, Y_PITCH
    lanes = 16 if which == "B x2" else 32
    for f in range(4 if which == "A" else 2):
        col = f * (16 if which == "A" else 8)
        addr = r * pitch + (col + c) * 2
        assert (addr % 16 == 0).all()
        for m in range(lanes // 8):
            assert len(set((addr[8 * m:8 * m + 8] // 16 % 8).tolist())) == 8


def test_dot_partial_tile_stores_hit_every_bank_once():
    """A warp stores each fragment row of its partial tile as float2 (lane
    g * 4 + t at row g, columns 2 t and 2 t + 1): each half-warp's 16 stores
    cover the 32 banks once at the padded pitch."""
    lane = np.arange(32)
    pitch = klow.DOT_BQ + 8
    for row0, col0 in ((0, 0), (8, 8), (48, 24)):
        word = (row0 + (lane >> 2)) * pitch + col0 + 2 * (lane & 3)
        for half in (slice(0, 16), slice(16, 32)):
            banks = np.concatenate([word[half] % 32, (word[half] + 1) % 32])
            assert sorted(banks.tolist()) == list(range(32))


def fold_dot(a, b, sms=132):
    """dot_tn's arithmetic in f32: each warp's products over its k16 steps,
    the warps summed in warp order, then a tile's splits in split order;
    returns the (M, N) result."""
    K, M, N = a.shape[0], a.shape[1], b.shape[1]
    swap = bool(M % 16)
    X, Y = (b, a) if swap else (a, b)
    P, Q = X.shape[1], Y.shape[1]
    plan = klow.dot_plan(K, P, Q, BASE, BASE, sms)
    D = np.zeros((P, Q), np.float32)
    for tile in range(plan.tiles_p * plan.tiles_q):
        p0, q0 = tile // plan.tiles_q * klow.DOT_BP, tile % plan.tiles_q * klow.DOT_BQ
        xs, ys = X[:, p0:p0 + klow.DOT_BP], Y[:, q0:q0 + klow.DOT_BQ]
        total = np.zeros((xs.shape[1], ys.shape[1]), np.float32)
        for split in range(plan.splits):
            steps = np.arange(plan.per * split, min(plan.per * split + plan.per, plan.steps))
            block = np.zeros_like(total)
            for w in range(klow.DOT_WARPS):
                mine = steps[(steps - steps[0]) % klow.DOT_WARPS == w]
                rows = (16 * mine[:, None] + np.arange(16)).ravel()
                block += xs[rows].T @ ys[rows] if rows.size else 0
            total += block
        D[p0:p0 + xs.shape[1], q0:q0 + ys.shape[1]] = total
    return D.T if swap else D


@pytest.mark.parametrize("shape", [(256, 128, 128), (4096, 8, 128), (4112, 48, 24),
                                   (272, 8, 208), (1 << 16, 8, 128)])
def test_dot_fold_in_split_order_equals_the_twin(shape):
    """On integer-valued inputs in [-2, 2] every partial sum stays below
    2^24, so the fold is exact and equals the twin whatever its order."""
    K, M, N = shape
    rng = np.random.default_rng(K + M + N)
    a = rng.integers(-2, 3, (K, M)).astype(np.float32)
    b = rng.integers(-2, 3, (K, N)).astype(np.float32)
    want = klow.dot_tn_reference(torch.from_numpy(a).to(torch.bfloat16),
                                 torch.from_numpy(b).to(torch.bfloat16)).numpy()
    np.testing.assert_array_equal(fold_dot(a, b), want)


@pytest.mark.parametrize("entry,at", [("_ONEHOT_DOT", 2), ("_DOT_TN", 3), ("_IOTA_MOD_ADD", 2),
                                      ("_IOTA_MOD_ADD", 3)])
def test_counts_past_32_bits_reach_the_entry_unchanged(monkeypatch, entry, at):
    """n = 2^32 + 16 tokens (onehot_dot), K = 2^32 + 16 (dot_tn) and rows or
    cols = 2^32 + 16 (iota_mod_add) cross ctypes whole; under a 32-bit int
    they arrive as 16."""
    _cuda_stubs(monkeypatch)
    e = getattr(klow, entry)
    seen = []
    stub = ctypes.CFUNCTYPE(ctypes.c_int, *e.argtypes, ctypes.c_void_p)(
        lambda *args: seen.append(args) or 0)
    monkeypatch.setattr(e, "fn", stub)
    args = [16] * len(e.argtypes)
    args[at] = 2**32 + 16
    e(0, *args)
    assert seen[0][at] == 2**32 + 16
    cut = []
    ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_int)(lambda v: cut.append(v) or 0)(2**32 + 16)
    assert cut == [16]  # what the c_int argument of the first port did


class _Recorder:
    def __init__(self, rc):
        self.rc, self.calls = rc, []

    def __call__(self, *args):
        self.calls.append(args)
        return self.rc


def _cuda_stubs(monkeypatch, current=0, entered=None):
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: current, raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda i: 1000 + i,
                        raising=False)

    class Device:
        def __init__(self, index):
            self.index = index

        def __enter__(self):
            entered.append(self.index)

        def __exit__(self, *exc):
            return False

    if entered is not None:
        monkeypatch.setattr(torch.cuda, "device", Device)


def test_launch_helper_raises_on_a_cuda_error(monkeypatch):
    _cuda_stubs(monkeypatch)
    entry = _build.Entry("lowering", "zbpe_rows_to_column", (None,))
    entry.fn = _Recorder(700)  # cudaErrorIllegalAddress
    with pytest.raises(RuntimeError, match="zbpe_rows_to_column launch failed: CUDA error 700"):
        entry(0, 1, 2, 3)


def test_launch_helper_appends_the_raw_stream(monkeypatch):
    entered = []
    _cuda_stubs(monkeypatch, current=0, entered=entered)
    entry = _build.Entry("lowering", "zbpe_transpose", ())
    entry.fn = _Recorder(0)
    entry(0, 11, 22)
    entry(3, 33)  # another device: its context is entered for the launch
    assert entry.fn.calls == [(11, 22, 1000), (33, 1003)]
    assert entered == [3]


def test_launch_helper_resolves_once(monkeypatch):
    _cuda_stubs(monkeypatch)
    fn = _Recorder(0)

    class Lib:
        zbpe_x = fn

    looked = []
    monkeypatch.setattr(_build, "library", lambda name: looked.append(name) or Lib)
    entry = _build.Entry("lowering", "zbpe_x", (klow.P, klow.LL))
    entry(0, 1, 2)
    entry(0, 3, 4)
    assert looked == ["lowering"] and entry.fn is fn
    assert fn.argtypes == [klow.P, klow.LL, klow.P] and fn.calls == [(1, 2, 1000), (3, 4, 1000)]


def test_launch_probe_needs_a_card():
    """The launch probe times CUDA launches: on the CPU it refuses, with no
    twin to fall back to."""
    from zigbpe_tpu_torch.probes import __main__ as probes_main

    with pytest.raises(ValueError, match="times CUDA launches"):
        probes_main.main(["--device", "cpu", "launch", "--calls", "10"])
