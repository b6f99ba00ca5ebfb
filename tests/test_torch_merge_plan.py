"""The single-launch plan of the merge kernel (``csrc/merge.cu``), on the CPU.

A CUDA kernel cannot run here, so these tests replay its plan in numpy
(``merge.replay_pass``): blocks that take tiles in order from a counter and
hold at most two, per-tile status words, the one-tile look-back for the
head kill, the decoupled look-back of the slot-0 parity carry (as the pair
(count, last non-candidate rank) and as the kernel's two-bit image of it,
which must agree at every tile), in-place stores that wait for the
predecessor's word, and the last block's fold of the stats. The tiles'
steps interleave in random orders; every replay must equal the plain twin
``merge_pass_multi_reference``, and none may deadlock. Tiles of 1-4 rows
make many tiles, and long look-backs, at small sizes. ``chip_smoke.py``
holds the kernel itself to the twin on the card.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from tests.test_torch_merge_kernel import SINGLE_PASS, _drain_layout, _input
from zigbpe_tpu_torch.models import oracle
from zigbpe_tpu_torch.ops.kernels import merge as kmerge

CSRC = Path(__file__).resolve().parents[1] / "zigbpe_tpu_torch" / "csrc" / "merge.cu"


def _twin(arr: np.ndarray, table) -> tuple[np.ndarray, np.ndarray]:
    t = torch.from_numpy(arr.copy())
    out, stats = kmerge.merge_pass_multi_reference(t, torch.tensor(table, dtype=torch.int32))
    return out.numpy(), stats.numpy()


def _agree(arr: np.ndarray, table, tile_rows: int, blocks: int, seed: int) -> np.ndarray:
    """The replay equals the twin: tokens, hits, length and min_kept."""
    table = np.asarray(table, np.int32).reshape(-1, 3)
    want, wstats = _twin(arr, table)
    got, gstats = kmerge.replay_pass(arr, table, tile_rows=tile_rows, blocks=blocks, seed=seed)
    np.testing.assert_array_equal(got, want)
    assert gstats.tolist() == wstats.tolist()
    return got


@pytest.mark.parametrize("tile_rows,blocks", [(32, 4), (2, 3), (1, 5)])
@pytest.mark.parametrize("case", sorted(SINGLE_PASS))
def test_replay_matches_the_twin_on_every_merge_kernel_case(case, tile_rows, blocks):
    data, table, cap = SINGLE_PASS[case]
    for seed in range(2):
        _agree(_input(data, cap), table, tile_rows, blocks, seed)


@pytest.mark.parametrize("data,pair", [(b"aaaaa", (97, 97)), (b"abcab" * 300, (97, 98))],
                         ids=["aaaaa", "abcab"])
def test_replay_matches_the_twin_on_single_pairs(data, pair):
    _agree(_input(data, 2048), [(*pair, 256)], 1, 4, 0)


@pytest.mark.parametrize("seed", range(10))
def test_replay_matches_the_twin_on_random_chain_free_groups(seed):
    r = np.random.default_rng(seed)
    data = bytes(r.integers(97, 105, 3000, dtype=np.uint8))
    toks = list(range(97, 105))
    r.shuffle(toks)
    table = [(toks[2 * i], toks[2 * i + 1], 256 + i) for i in range(4)]
    got = _agree(_input(data, 4096), table, int(r.integers(1, 5)), int(r.integers(1, 9)), seed)
    want = list(data)
    for a, b, x in table:
        want = oracle.merge_pass(want, a, b, x)
    assert got[got >= 0].tolist() == want


@pytest.mark.parametrize("seed", range(6))
def test_replay_of_a_parity_run_spanning_every_tile(seed):
    """``a`` repeated over 64 one-row tiles: every tile's carry depends on
    all before it, so the look-back composes windows of 32 tiles; the row
    ends are ragged, and the blocks take tiles in random interleavings."""
    r = np.random.default_rng(seed)
    arr = np.full((64, 128), -1, np.int32)
    for row in range(64):
        arr[row, : int(r.integers(100, 129))] = 97
    arr = arr.reshape(-1)
    for p in range(3):
        t = 97 if p == 0 else 255 + p
        arr = _agree(arr, [(t, t, 256 + p)], 1, int(r.integers(1, 40)), seed * 3 + p)


@pytest.mark.parametrize("tile_rows", [3, 4, 7])
def test_replay_with_a_ragged_last_tile(tile_rows):
    """A capacity of 37 rows: the last tile holds fewer rows than the
    others, the rest of it PAD that is never stored."""
    data = bytes(np.random.default_rng(tile_rows).integers(97, 100, 37 * 120, dtype=np.uint8))
    for table in ([(97, 98, 256)], [(97, 97, 256)], [(97, 97, 256), (98, 99, 257)]):
        _agree(_input(data, 128 * 37), table, tile_rows, 6, tile_rows)


def test_replay_flags_draining_rows_as_the_twin_does():
    data = b"a" * 1024 + b"bcd" * 400
    out = _input(data, 4096)
    tok, flagged = 97, 0
    for r in range(10):
        table = np.array([(tok, tok, 256 + r)], np.int32)
        want, wstats = _twin(out, table)
        out, stats = kmerge.replay_pass(out, table, tile_rows=1, blocks=3, seed=r)
        np.testing.assert_array_equal(out, want)
        assert stats.tolist() == wstats.tolist()
        if stats[2] <= 1:
            flagged += 1
            out = np.concatenate([out[out >= 0], out[out < 0]])
        tok = 256 + r
    assert flagged > 0


@pytest.mark.parametrize("idle", [False, True])
@pytest.mark.parametrize("tile_rows", [1, 8, 32])
def test_replay_folds_the_deferred_row(idle, tile_rows):
    """Rows drained to one token at a tile's end: the last block's fold
    leaves out only the stream's last non-empty row."""
    arr = _drain_layout(idle)
    for seed in range(3):
        _agree(arr, [(97, 97, 256)], tile_rows, 3, seed)
    _agree(_input(b"c" * 128 + b"a" * 128, 1024), [(97, 97, 256)], 1, 2, 0)


@pytest.mark.parametrize("blocks", [1, 2, 33, 200])
def test_replay_never_deadlocks_at_any_grid(blocks):
    """From one block to more blocks than tiles, with a == b (the longest
    waits): each wait is on an earlier tile, so some block can always move."""
    arr = _input(b"a" * 4000 + b"ab" * 40, 8192)
    _agree(arr, [(97, 97, 256)], 1, blocks, blocks)


# --------------------------------------------------------------- the carry

_carries = st.integers(0, 10**6).flatmap(
    lambda s: st.tuples(st.just(s), st.integers(-1, s - 1)))


@settings(max_examples=300, deadline=None)
@given(_carries, _carries, _carries)
def test_carry_combine_is_associative(p1, p2, p3):
    c = kmerge.carry_combine
    assert c(c(p1, p2), p3) == c(p1, c(p2, p3))


@settings(max_examples=200, deadline=None)
@given(_carries)
def test_carry_identity(p):
    c, e = kmerge.carry_combine, kmerge.CARRY_IDENTITY
    assert e == (0, -1)
    assert c(e, p) == p == c(p, e)


@settings(max_examples=300, deadline=None)
@given(_carries, _carries)
def test_the_kernels_bits_are_the_carrys_image(p1, p2):
    """What the kernel keeps of a carry (h and a span's two-bit function)
    composes as the pair combines."""
    c = kmerge.carry_combine
    assert kmerge.carry_bit(c(p1, p2)) == kmerge.fn_apply(kmerge.carry_fn(p2),
                                                          kmerge.carry_bit(p1))
    assert kmerge.carry_fn(c(p1, p2)) == kmerge.fn_compose(kmerge.carry_fn(p2),
                                                           kmerge.carry_fn(p1))


@pytest.mark.parametrize("g", [1, 2, 31, 32, 33, 34, 65, 100])
@pytest.mark.parametrize("inclusive_at", [0, 1, 17, 40])
def test_look_back_windows_compose_to_the_pair_walk(g, inclusive_at):
    """Tiles 0 and ``inclusive_at`` inclusive, every other tile before g an
    aggregate: the kernel's windows of 32 give the h entering g and the
    edge hit of g - 1 that combining the pairs gives, and when the first
    window reaches an inclusive word, the tiles it passed get theirs."""
    r = np.random.default_rng(g * 100 + inclusive_at)
    carries = []
    for _ in range(g):
        s = int(r.integers(0, 9))
        carries.append((s, int(r.integers(-1, s)) if s else -1))
    edges = [tuple(int(v) for v in r.integers(0, 2, 3)) for _ in range(g)]
    prefix, words, before = kmerge.CARRY_IDENTITY, {}, []
    for j in range(g):
        before.append(prefix)
        prefix = kmerge.carry_combine(prefix, carries[j])
        if j in (0, inclusive_at):
            ec, ed, ex = edges[j]
            h = kmerge.carry_bit(before[j])
            words[j] = (True, kmerge.carry_bit(prefix), int(ec or (ed and h ^ ex)))
        else:
            words[j] = (False, kmerge.carry_fn(carries[j]), edges[j])

    def edge_hit(j):
        ec, ed, ex = edges[j]
        return int(ec or (ed and kmerge.carry_bit(before[j]) ^ ex))

    got = kmerge.look_back_bits(words, g)
    assert got[:2] == (kmerge.carry_bit(prefix), edge_hit(g - 1))
    # the tiles it passes get the inclusive words they would publish themselves
    last_incl = max(j for j in (0, inclusive_at) if j < g)
    if g - 1 - last_incl <= 31:
        assert set(got[2]) == set(range(last_incl + 1, g - 1))
    else:
        assert got[2] == {}
    for j, word in got[2].items():
        assert word == (True, kmerge.carry_bit(kmerge.carry_combine(before[j], carries[j])),
                        edge_hit(j))
    if 0 < inclusive_at < g - 1:  # a missing word past the first inclusive one: no wait
        del words[inclusive_at - 1]
        assert kmerge.look_back_bits(words, g) == got
    if g > 1 and g - 1 != inclusive_at:  # a missing predecessor's word: spin
        del words[g - 2]
        assert kmerge.look_back_bits(words, g) is None


# ------------------------------------------------------------- the source

def test_plan_constants_match_the_kernel_source():
    src = CSRC.read_text()
    ints = {m[0]: int(m[1]) for m in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert (ints["TILE_ROWS"], ints["THREADS"], ints["MAXK"]) == (
        kmerge.TILE_ROWS, kmerge.THREADS, kmerge.MAX_SLOTS)
    bits = {m[0]: int(m[1]) for m in re.findall(r"constexpr unsigned (FN_\w+) = (\d+);", src)}
    assert bits == {"FN_Q": kmerge.FN_Q, "FN_NC": kmerge.FN_NC}


def test_the_kernel_source_launches_once_a_pass():
    """One launch statement, no zeroing per pass, and the note on why its
    waits cannot deadlock."""
    src = CSRC.read_text()
    assert src.count("<<<") == 1 and "cudaMemsetAsync" not in src
    assert "WHY NO WAIT CAN DEADLOCK" in src
