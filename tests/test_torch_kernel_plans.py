"""The launch geometry of the redesigned copy and histogram kernels
(``csrc/copy.cu``, ``csrc/hist.cu``), on the CPU.

A CUDA kernel cannot run here, so these tests replay the index map of each
plan in numpy (:func:`copy.copy_plan`, :func:`hist.hist_plan`): which
vectors each thread of each block moves, which look-ahead term each thread
of ``copy_peek`` adds, and which steps each block of the histogram's
persistent grid walks, votes on and counts. Every 16-byte vector must move
exactly once, every term be added once per block of R rows, and every
subchunk be voted on and counted once, so that the replayed results equal
the plain twins'. ``chip_smoke.py`` holds the plans equal to the geometry
the C entries launch, on the card.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from zigbpe_tpu_torch.ops.kernels import copy as kcopy
from zigbpe_tpu_torch.ops.kernels import hist as khist

REPO = Path(__file__).resolve().parents[1]
CSRC = REPO / "zigbpe_tpu_torch" / "csrc"


def _constants(name: str) -> dict:
    src = (CSRC / name).read_text()
    return {m[0]: int(m[1]) for m in
            re.findall(r"constexpr (?:int|long long) (\w+) = (\d+);", src)}


# ------------------------------------------------------------------ copy

def replay_copy(plan: kcopy.CopyPlan) -> np.ndarray:
    """The number of times copy_kernel moves each 16-byte vector: thread t
    of block b moves b * THREADS * VPT + t + u * THREADS for u < VPT, when
    below n4."""
    b = np.arange(plan.grid)[:, None, None]
    u = np.arange(kcopy.VPT)[None, :, None]
    t = np.arange(kcopy.THREADS)[None, None, :]
    i = (b * kcopy.THREADS * kcopy.VPT + u * kcopy.THREADS + t).reshape(-1)
    return np.bincount(i[i < plan.n4], minlength=plan.n4)


def replay_terms(plan: kcopy.CopyPlan, rows: int, R: int) -> np.ndarray:
    """The rows whose first token copy_peek's threads add: global thread g
    adds term g, row min((g + 1) R, rows - 8), for g < terms."""
    g = np.arange(plan.grid * kcopy.THREADS)
    g = g[g < plan.terms]
    return np.minimum((g + 1) * R, rows - 8)


@pytest.mark.parametrize("kernel", kcopy.MODES)
@pytest.mark.parametrize("elem", [4, 2])
@pytest.mark.parametrize("rows,R", [(1, 1), (3, 3), (8, 8), (31, 1), (33, 11), (64, 8),
                                    (77, 7), (1000, 8), (1025, 25), (4096, 256)])
def test_copy_moves_every_vector_once(kernel, elem, rows, R):
    if kernel == "copy_peek" and (rows % 8 or R % 8):
        with pytest.raises(ValueError, match="takes no"):
            kcopy.copy_plan(rows, R, elem, kernel)
        return
    plan = kcopy.copy_plan(rows, R, elem, kernel)
    assert plan.n4 * 16 == rows * 128 * elem
    assert (replay_copy(plan) == 1).all()
    assert plan.grid == -(-plan.n4 // (kcopy.THREADS * kcopy.VPT))


@pytest.mark.parametrize("dtype", [torch.int32, torch.int16])
@pytest.mark.parametrize("rows,R", [(8, 8), (16, 8), (64, 8), (64, 16), (1024, 8), (1024, 128),
                                    (1024, 1024), (2048, 256), (40, 40)])
def test_copy_peek_adds_every_term_once(dtype, rows, R):
    """Each block i of R rows adds x[min((i + 1) R, rows - 8), 0] once: at
    R = 8 the last two terms read row rows - 8, and two threads add it."""
    plan = kcopy.copy_plan(rows, R, dtype.itemsize, "copy_peek")
    ahead = replay_terms(plan, rows, R)
    i = np.arange(rows // R)
    np.testing.assert_array_equal(ahead, np.minimum((i + 1) * R, rows - 8))
    if R == 8 and rows >= 16:
        assert (ahead == rows - 8).sum() == 2
    x = torch.from_numpy(np.random.default_rng(rows + R).integers(
        -2**15, 2**15 - 1, (rows, 128))).to(dtype)
    total = int((x >= 0).sum()) + int(x[torch.from_numpy(ahead), 0].long().sum())
    want = kcopy.copy_peek_reference(x, R)[1]
    assert want.item() == (total + 2**31) % 2**32 - 2**31


@pytest.mark.parametrize("kernel", ["copy_blocks", "copy_carry"])
def test_copy_terms_are_for_peek_only(kernel):
    assert kcopy.copy_plan(1024, 8, 4, kernel).terms == 0


@pytest.mark.parametrize("rows", [8, 1 << 18, 1 << 30])
@pytest.mark.parametrize("elem", [4, 2])
def test_copy_grid_holds_every_term(rows, elem):
    """The grid's threads outnumber the look-ahead terms at every size, even
    at R = 8, so that one thread a term is always enough."""
    plan = kcopy.copy_plan(rows, 8, elem, "copy_peek")
    assert plan.terms == rows // 8 <= plan.grid * kcopy.THREADS


@pytest.mark.parametrize("call", [
    lambda: kcopy.copy_plan(0, 8, 4, "copy_blocks"),
    lambda: kcopy.copy_plan(24, 16, 4, "copy_carry"),
    lambda: kcopy.copy_plan(16, 8, 8, "copy_blocks"),
    lambda: kcopy.copy_plan(12, 4, 4, "copy_peek"),
    lambda: kcopy.copy_plan(1 << 41, 1, 4, "copy_blocks"),
])
def test_copy_plan_refuses_what_the_entries_refuse(call):
    with pytest.raises(ValueError):
        call()


def test_copy_constants_match_the_kernel_source():
    cu = _constants("copy.cu")
    src = (CSRC / "copy.cu").read_text()
    assert (cu["THREADS"], cu["VPT"], cu["GRID_X_MAX"]) == (kcopy.THREADS, kcopy.VPT,
                                                             kcopy.GRID_X_MAX)
    modes = re.search(r"enum Mode \{ COPY = 0, CARRY = 1, PEEK = 2 \};", src)
    assert modes and kcopy.MODES == ("copy_blocks", "copy_carry", "copy_peek")


# ------------------------------------------------------------------ hist

def replay_hist(x: np.ndarray, R: int, V: int, S: int, dmod: int, skip: bool, sms: int,
                bps: int):
    """What hist_kernel does under ``hist_plan``, block by block and step by
    step: returns the copy, the histogram (the blocks' private histograms
    added up, as the flush does) and the number of times each subchunk was
    voted on (with skip) and each vector moved."""
    plan = khist.hist_plan(x.shape[0], R, S, V, dmod, skip, sms, bps)
    flat4 = x.reshape(-1, 4)
    n4 = flat4.shape[0]
    span = plan.vh * 128
    assert plan.span4 <= khist.THREADS * plan.per  # a step is held in registers whole
    moved = np.zeros(n4, np.int64)
    voted = np.zeros(-(-x.shape[0] // S), np.int64)
    out = np.full_like(flat4, 7777)
    hist = np.zeros(2 * span, np.int64)
    c = plan.divc
    for b in range(plan.grid):
        private = np.zeros(2 * span, np.int64)
        for step in range(b, plan.steps, plan.grid):
            t = np.arange(khist.THREADS)[:, None]
            k = np.arange(plan.per)[None, :]
            i = (step * plan.span4 + t + k * khist.THREADS).reshape(-1)
            i = i[i < min((step + 1) * plan.span4, n4)]
            np.add.at(moved, i, 1)
            out[i] = flat4[i]
            tok = flat4[i].reshape(-1).astype(np.int64)
            u = np.abs(tok).astype(np.uint64)  # the kernel's |t| as unsigned
            with np.errstate(over="ignore"):  # uint64 products wrap mod 2^64, as the kernel's
                hit = u * np.uint64(c) <= np.uint64((c - 1) % 2**64)
            hit &= bool(dmod)
            if skip:
                assert plan.span4 == S * khist.ROW_VECS
                voted[step] += 1
                if not hit.any():
                    continue
            keep = (tok >= 0) & (tok < span)
            np.add.at(private, tok[keep] + span * hit[keep], 1)
        hist += private
    return plan, out.reshape(x.shape), hist.reshape(-1, 128), voted, moved


def _tokens(rows: int, seed: int) -> np.ndarray:
    """Seeded tokens in [-300, 5000) with every third S-row subchunk free of
    hits for S = 8 (every multiple of 7 moved up by one), and a run of
    zeros."""
    x = np.random.default_rng(seed).integers(-300, 5000, (rows, 128)).astype(np.int32)
    sub = x[: rows // 8 * 8].reshape(-1, 8 * 128)
    sub[1::3] += (sub[1::3] % 7 == 0)
    x[: rows // 4] = 0
    return x


@pytest.mark.parametrize("S,R,rows", [(1, 1, 77), (1, 3, 6), (8, 8, 24), (8, 16, 48),
                                      (32, 32, 64), (32, 256, 256), (96, 96, 192),
                                      (96, 192, 192)])
@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("sms,bps", [(1, 1), (3, 2), (132, 5)])
def test_hist_steps_cover_every_subchunk_once(S, R, rows, skip, sms, bps):
    x = _tokens(rows, S * 1000 + rows)
    for V in (1, 512, 4352):
        plan, out, hist, voted, moved = replay_hist(x, R, V, S, 7, skip, sms, bps)
        assert (moved == 1).all()
        np.testing.assert_array_equal(out, x)
        if skip:
            assert (voted == 1).all() and plan.steps == rows // S
        want = khist.onehot_hist_reference(torch.from_numpy(x), R, V, S, 7, skip)[1]
        np.testing.assert_array_equal(hist, want.numpy())


@pytest.mark.parametrize("dmod", [0, 1, 2, 7, 96])
def test_hist_replay_matches_the_twin_for_every_density(dmod):
    x = _tokens(64, dmod)
    for skip in (False, True):
        _, _, hist, _, _ = replay_hist(x, 32, 4608, 8, dmod, skip, 2, 3)
        want = khist.onehot_hist_reference(torch.from_numpy(x), 32, 4608, 8, dmod, skip)[1]
        np.testing.assert_array_equal(hist, want.numpy())


def test_hist_steps_and_grid():
    """Without skip a step is 32 rows, four vectors a thread; with skip an
    S-row subchunk, up to 12 vectors a thread for S up to 96; the grid is
    what fits on the card at once, or fewer steps."""
    p = khist.hist_plan(262144, 256, 32, 4352, 7, False, 132, 5)
    assert (p.span4, p.per, p.steps, p.grid) == (1024, 4, 8192, 660)
    p = khist.hist_plan(262144, 256, 8, 512, 7, True, 132, 5)
    assert (p.span4, p.per, p.steps, p.grid) == (256, 4, 32768, 660)
    p = khist.hist_plan(192, 96, 96, 4608, 0, True, 132, 3)
    assert (p.span4, p.per, p.steps, p.grid, p.divc) == (3072, 12, 2, 2, 0)
    p = khist.hist_plan(77, 77, 1, 1, 3, True, 132, 5)
    assert (p.span4, p.per, p.steps, p.grid) == (32, 4, 77, 77)


@pytest.mark.parametrize("S", list(range(1, 97)))
def test_hist_instantiation_holds_the_step(S):
    plan = khist.hist_plan(S, S, S, 512, 7, True, 132, 5)
    assert plan.span4 <= khist.THREADS * plan.per
    assert plan.per == (khist.PER_SMALL if S <= 32 else khist.PER_WIDE)


def test_hist_shared_histogram_fits_for_every_vocab():
    """A block's histogram is static-size shared memory (no opt-in) for
    every V the wrapper takes, and nothing past it is taken."""
    for V in range(1, khist.MAX_VOCAB + 1):
        plan = khist.hist_plan(8, 8, 8, V, 7, False, 132, 5)
        assert plan.smem == 2 * plan.vh * 128 * 4 <= 48 * 1024
    with pytest.raises(ValueError):
        khist.hist_plan(8, 8, 8, khist.MAX_VOCAB + 1, 7, False, 132, 5)


@pytest.mark.parametrize("dmod", list(range(1, 40)) + [96, 127, 4096, 65537, 2**31 - 1])
def test_hit_multiplier_tests_divisibility_of_every_int32(dmod):
    """(|t| * c) mod 2^64 <= c - 1 exactly when t % d == 0, for int32 t at
    the edges and seeded ones."""
    c = khist.hit_multiplier(dmod)
    edges = [0, 1, -1, dmod - 1, 2**31 - 1, -2**31, -2**31 + 1]
    near = [k * dmod + e for k in range(-3, 4) for e in (-1, 0, 1)]  # multiples and neighbours
    t = np.array([v for v in edges + near if -2**31 <= v < 2**31]
                 + np.random.default_rng(dmod).integers(-2**31, 2**31, 5000).tolist())
    u = [abs(int(v)) for v in t]
    got = [(v * c) % 2**64 <= (c - 1) % 2**64 for v in u]
    assert got == [int(v) % dmod == 0 for v in t]


def test_hist_plan_refuses_what_the_entry_refuses():
    for args in ((0, 8, 8, 512, 7), (16, 3, 1, 512, 7), (16, 8, 3, 512, 7),
                 (192, 192, 192, 512, 7), (16, 8, 8, 0, 7), (16, 8, 8, 512, -1)):
        with pytest.raises(ValueError, match="takes no"):
            khist.hist_plan(*args, False, 132, 5)


def test_hist_constants_match_the_kernel_source():
    """The plan's constants are csrc/hist.cu's, the entry's argument types
    are the C entry's, and the mma.sync design is gone."""
    cu = _constants("hist.cu")
    for name in ("THREADS", "ROW_VECS", "PER_SMALL", "PER_WIDE", "MAX_SUB_ROWS", "MAX_VH"):
        assert cu.get(name, getattr(khist, name)) == getattr(khist, name), name
    assert {"THREADS", "PER_SMALL", "PER_WIDE", "MAX_SUB_ROWS", "MAX_VH"} <= set(cu)
    src = (CSRC / "hist.cu").read_text()
    assert "mma" not in src
    assert "~0ull / (unsigned)dmod + 1" in src
