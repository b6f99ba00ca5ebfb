"""The launch geometry of the redesigned copies (``transpose`` and
``rows_to_column``, ``csrc/lowering.cu``) and the lean launch helper
(``ops/kernels/_build.Entry``), on the CPU.

A CUDA kernel cannot run here, so these tests replay its index map in
numpy: every block and thread of ``transpose_plan`` / ``column_plan``
writes what the kernel's loops write, through the same swizzled tile in
shared memory, and each element of the output must be written exactly
once, with its source element, by 16-byte vectors only where both ends are
16-byte aligned. The replay also checks the shared-memory banks of the
vector paths. ``chip_smoke.py`` holds the plans equal to the geometry the C
entries launch, on the card.
"""

from __future__ import annotations

import ctypes
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
])
def test_plans_refuse_what_the_kernels_cannot_index(call, match):
    with pytest.raises(ValueError, match=match):
        call()


def test_plan_constants_match_the_kernel_source():
    """The plans' constants are csrc/lowering.cu's, and the launch entries'
    argument types carry n, rows and cols as 64-bit integers."""
    src = (REPO / "zigbpe_tpu_torch" / "csrc" / "lowering.cu").read_text()
    cu = {m[0]: int(m[1]) for m in re.findall(r"constexpr (?:int|long long) (\w+) = (\d+);", src)}
    for name in ("TILE", "TILE_THREADS", "VEC", "COLUMN_THREADS", "GRID_X_MAX"):
        assert cu[name] == getattr(klow, name), name
    assert "int zbpe_rows_to_column(const int* src, int* dst, long long n, void* stream)" in src
    assert ("int zbpe_transpose(const int* src, int* dst, long long rows, long long cols, "
            "void* stream)") in src
    assert klow._ROWS_TO_COLUMN.argtypes[2] is ctypes.c_longlong
    assert klow._TRANSPOSE.argtypes[2:] == (ctypes.c_longlong, ctypes.c_longlong)


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
