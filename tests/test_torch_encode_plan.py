"""The plan of the encode kernel (``csrc/encode.cu``), on the CPU.

A CUDA kernel cannot run here, so these tests replay its plan in numpy
(``encode.replay_rows``): warps striped over a row held in shared memory
with a PAD sentinel after it, pass tables staged one pass ahead into the
other of two buffers (a collision-free table under packed 32-bit keys, or
a linear-probing one), independent probes, per-warp published words and
the offsets formed from them, the a == b run start carried across warps
and steps (the bits transposed as the kernel transposes them), and
in-place writes in a random warp order after every load is done. Small
warps (a few lanes, a few steps) put many warp boundaries into short rows.
Every replay must equal the plain twin ``encode_rows_grouped_reference``
token for token (tolerance 0: all values are integers). ``chip_smoke.py``
holds the kernel itself to the twin on the card.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from tests.test_encode_fuzz import _adversarial_table, _docs
from tests.test_torch_encode_kernel import JAX_SEEDS, KERNEL_CASES, _batch, _fuzz_case
from zigbpe_tpu.native import fastio
from zigbpe_tpu_torch.models import oracle
from zigbpe_tpu_torch.ops.kernels import encode as ke

CSRC = Path(__file__).resolve().parents[1] / "zigbpe_tpu_torch" / "csrc" / "encode.cu"
SMALL = [(4, 2), (3, 3), (32, 32)]  # (lanes, steps) of a warp
SMEM_LIMIT = 232448  # bytes of shared memory one block may take on an H100


def _agree(buf, gt, gl, lanes: int, steps: int, seed: int = 0):
    """The replay equals the twin on ``buf``: tokens and lengths."""
    want, wlen = ke.encode_rows_grouped_reference(
        torch.from_numpy(np.ascontiguousarray(buf, np.int32)), torch.from_numpy(gt),
        torch.from_numpy(gl))
    got, glen = ke.replay_rows(buf, gt, gl, lanes=lanes, steps=steps, seed=seed)
    np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(glen, wlen.numpy())
    return got, glen


def _grouped(merges, cap: int, grouper=ke.group_merges):
    return grouper(np.asarray(merges, np.int32).reshape(-1, 3), cap=cap)


# ------------------------------------------------ the replay against the twin

@pytest.mark.parametrize("lanes,steps", SMALL)
@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_replay_matches_the_twin_on_every_kernel_case(case, lanes, steps):
    docs, merges = KERNEL_CASES[case]
    gt, gl = _grouped(merges, 16)
    _agree(_batch(docs), gt, gl, lanes, steps, seed=lanes)


@pytest.mark.parametrize("seed", JAX_SEEDS)
def test_replay_matches_the_twin_on_the_jax_seeds(seed):
    buf, gt, gl, *_ = _fuzz_case(seed)
    _agree(buf, gt, gl, 4, 2, seed)


@pytest.mark.parametrize("seed", range(50))
def test_replay_matches_the_twin_and_the_oracle_on_fuzz_tables(seed):
    """Adversarial tables (repeated pairs, minted ids fed back, chains,
    a == b, ids up to 65535) under both groupers at caps 4-16, on rows
    crossing many 3-lane warps."""
    buf, gt, gl, table, docs, cap, grouper = _fuzz_case(seed)
    got, lens = _agree(buf, gt, gl, 3, 2, seed)
    assert [got[i, : lens[i]].tolist() for i in range(len(docs))] == [
        oracle.encode(d, table) for d in docs]


@pytest.fixture(scope="module")
def table_1k(corpus_bytes):
    table = np.asarray(fastio.train(corpus_bytes, 256 + 1024), np.int32).reshape(-1, 3)
    assert table.shape == (1024, 3)
    return table


@pytest.mark.parametrize("grouper,cap", [(ke.group_merges, 16), (ke.schedule_merges, 32)])
def test_replay_of_the_trained_1k_table(table_1k, corpus_bytes, grouper, cap):
    """The serving table: mostly collision-free tables, a few a == b
    singletons, rows of real text that shrink by half."""
    gt, gl = grouper(table_1k, cap=cap)
    docs = [corpus_bytes[5000: 5000 + 1500], corpus_bytes[90000: 90000 + 1024]]
    _agree(_batch(docs, 1536), gt, gl, 8, 4, cap)


@pytest.mark.parametrize("lanes,steps", [(4, 2), (32, 32)])
def test_replay_of_a_long_run_of_one_byte(lanes, steps):
    """``a`` over the whole row under doubling merges: every pass is a == b,
    and each run spans every warp, so the run start crosses all of them."""
    merges = [(97, 97, 256)] + [(256 + i, 256 + i, 257 + i) for i in range(10)]
    gt, gl = _grouped(merges, 32, ke.schedule_merges)
    buf = _batch([b"a" * 2000, b"a" * 1023 + b"b" + b"a" * 900], 2048)
    got, lens = _agree(buf, gt, gl, lanes, steps)
    assert got[0, : lens[0]].tolist() == oracle.encode(b"a" * 2000, merges)


def test_replay_with_ids_past_65535():
    """Rows and tables with ids >= 65536: groups that hold one take the
    linear-probing table, the others probe with the width test."""
    wide = 70000
    r = np.random.default_rng(5)
    data = bytes(r.integers(97, 101, 900, dtype=np.uint8))
    merges = oracle.train(data, 280)
    buf = _batch([data, data[::-1]])
    buf[buf == 99] += wide
    table = np.asarray(merges, np.int32)
    pairs = table[:, :2]
    pairs[pairs == 99] += wide
    table[::3, 2] += wide  # some groups mint wide ids too
    for grouper in (ke.group_merges, ke.schedule_merges):
        gt, gl = grouper(table, cap=8)
        got, _ = _agree(buf, gt, gl, 4, 3)
        assert (got >= wide).any()


@pytest.mark.parametrize("cap", [1, 1024])
def test_replay_at_the_extreme_caps(cap):
    """Cap 1 (every group a singleton) and cap 1024 (one group past 32
    members, so a linear-probing table filled by the loop over members)."""
    r = np.random.default_rng(cap)
    data = bytes(r.integers(97, 105, 1500, dtype=np.uint8))
    merges = oracle.train(data, 256 + 120)
    gt, gl = _grouped(merges, cap, ke.schedule_merges)
    if cap == 1024:
        # a group of 40 independent pairs of new ids on top
        extra = np.full((1, cap, 3), -1, np.int32)
        extra[0, :40] = [(1000 + i, 2000 + i, 3000 + i) for i in range(40)]
        gt, gl = np.concatenate([gt, extra]), np.concatenate([gl, [40]]).astype(np.int32)
    _agree(_batch([data], 1536), gt, gl, 4, 2)


@settings(max_examples=40, deadline=None)
@given(st.integers(0, 2**32 - 1), st.sampled_from([(4, 2), (2, 5), (32, 2)]))
def test_replay_in_random_warp_orders(seed, dims):
    r = np.random.default_rng(seed)
    data = bytes(r.integers(97, 100, int(r.integers(1, 300)), dtype=np.uint8))
    merges = [(97, 97, 256), (98, 99, 257), (256, 98, 258), (99, 99, 259)]
    gt, gl = _grouped(merges, 4, ke.schedule_merges)
    _agree(_batch([data, data[::2]]), gt, gl, *dims, seed % 1000)


# --------------------------------------------- the ground of the independent probes

def _chain_free(gt: np.ndarray, gl: np.ndarray) -> None:
    """Every group but an a == b singleton (the parity pass, which does not
    probe) is chain-free and has no a == b member."""
    for group, glen in zip(gt, gl):
        live = [tuple(m) for m in group[:glen].tolist() if min(m) >= 0]
        if glen == 1 and live and live[0][0] == live[0][1]:
            continue
        firsts = {a for a, _, _ in live}
        assert not any(b in firsts for _, b, _ in live), live
        assert all(a != b for a, b, _ in live), live


@pytest.mark.parametrize("seed", range(60))
@pytest.mark.parametrize("grouper", [ke.group_merges, ke.schedule_merges])
def test_groups_are_chain_free_on_fuzz_tables(seed, grouper):
    """No member's b is a member's a, and no member of a probed group has
    a == b: so the token after a hit never opens one, and every pair can be
    probed from the row as loaded."""
    r = np.random.default_rng(7000 + seed)
    table = np.asarray(_adversarial_table(r, int(r.integers(1, 60))), np.int32)
    for cap in (1, 16, 32):
        _chain_free(*grouper(table, cap=cap))


@pytest.mark.parametrize("grouper", [ke.group_merges, ke.schedule_merges])
def test_groups_are_chain_free_on_the_trained_1k_table(table_1k, grouper):
    for cap in (16, 32):
        _chain_free(*grouper(table_1k, cap=cap))


# --------------------------------------------------------- the pieces

def _parity_rule(cm: int, run: int, base: int) -> int:
    hits, r = 0, run
    for i in range(32):
        if (cm >> i) & 1:
            hits |= ((base + i - r) & 1) << i
        else:
            r = base + i
    return hits


@settings(max_examples=400, deadline=None)
@given(st.integers(0, 2**32 - 1), st.integers(0, 500), st.integers(-1, 31))
def test_parity_step_hits_follow_the_leftmost_greedy_rule(cm, step, back):
    """One add marks the runs of even parity: a candidate hits iff its
    distance to the last non-candidate before it is odd."""
    base = 32 * step
    run = base - 1 - back if base - 1 - back >= -1 else -1
    assert ke.parity_step_hits(cm, run, base) == _parity_rule(cm, run, base)


@settings(max_examples=100, deadline=None)
@given(st.lists(st.integers(0, 2**32 - 1), min_size=32, max_size=32))
def test_transpose32_is_the_bit_transpose(words):
    got = ke.transpose32(words)
    for i in range(32):
        for j in range(32):
            assert (got[j] >> i) & 1 == (words[i] >> j) & 1
    assert ke.transpose32(got) == [w & 0xFFFFFFFF for w in words]


@settings(max_examples=300, deadline=None)
@given(st.lists(st.booleans(), min_size=32, max_size=32), st.integers(0, 32),
       st.integers(0, 5000))
def test_step_places_are_the_kept_lanes_ranks(kept, n_valid, out):
    """A kept lane's place: its lane less the drops below it in the step
    (the valid lanes are a prefix: positions past the row come last)."""
    valid = np.arange(32) < n_valid
    keep = valid & np.array(kept)
    places, nxt = ke.step_places(keep, valid, out)
    assert places.tolist() == list(range(out, out + int(keep.sum())))
    assert nxt == out + 32 - int((valid & ~keep).sum())


def test_collision_free_tables_take_one_load_for_a_miss():
    """Every member of a PERFECT table sits in its own home slot, and a
    GENERAL table finds every member by linear probing."""
    r = np.random.default_rng(3)
    for _ in range(30):
        pairs = set()
        while len(pairs) < 32:
            pairs.add((int(r.integers(0, 65535)), int(r.integers(0, 65535))))
        members = np.array([(a, b, 300 + i) for i, (a, b) in enumerate(sorted(pairs))])
        t = ke.stage_table(members, 32, 32, r)
        assert t.mode == ke.PERFECT
        keys = ke.pack_key(members[:, 0], members[:, 1])
        slots = ke.perfect_slot(keys, t.mult, t.shift)
        assert len(set(slots.tolist())) == 32 and (t.k0[slots] == keys).all()
        for a, b, x in members.tolist():
            assert t.lookup(a, b) == x
    wide = members.copy()
    wide[0, 0] = 70000
    t = ke.stage_table(wide, 32, 32, r)
    assert t.mode == ke.GENERAL
    assert all(t.lookup(a, b) == x for a, b, x in wide.tolist())


def test_stage_table_modes():
    cap = 8
    dead = np.array([(97, 98, -1)] + [(-1, -1, -1)] * (cap - 1))
    assert ke.stage_table(dead, 1, cap).mode == ke.SKIP
    par = np.array([(97, 97, 256)] + [(-1, -1, -1)] * (cap - 1))
    t = ke.stage_table(par, 1, cap)
    assert (t.mode, t.a, t.x) == (ke.PARITY, 97, 256)
    minted = np.array([(97, 98, 70000)] + [(-1, -1, -1)] * (cap - 1))
    t = ke.stage_table(minted, 1, cap)
    assert t.mode == ke.PERFECT and t.lookup(97, 98) == 70000
    assert t.lookup(97 + 65536, 98) is None  # the width test: low halves alias


# ------------------------------------------------------- the layout

@pytest.mark.parametrize("cap", [1, 2, 16, 32, 64, 256, 512, 1024])
@pytest.mark.parametrize("L", [1024, 1152, 16384, 32768])
def test_shared_memory_fits_one_block(L, cap):
    words = ke.smem_words(L, cap)
    assert 4 * words <= SMEM_LIMIT
    assert ke.row_words(L) >= L + 1 and ke.row_words(L) % 4 == 0
    assert ke.block_warps(L) * 32 <= ke.MAX_THREADS
    slots, shift = ke.table_slots(cap)
    assert slots >= 4 * cap and 1 << (32 - shift) == slots


def test_warps_cover_the_row():
    assert ke.block_warps(32768) == 32 and ke.block_warps(1024) == 1
    assert ke.block_warps(1152) == 2


# ---------------------------------------------------------- the source

def test_plan_constants_match_the_kernel_source():
    src = CSRC.read_text()
    ints = {m[0]: int(m[1]) for m in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert (ints["C"], ints["MAX_THREADS"], ints["MIN_SLOTS"], ints["MAX_SLOTS"],
            ints["SLOTS_PER_MEMBER"], ints["SEEDS"], ints["CTL"], ints["RAW"]) == (
        ke.STEPS, ke.MAX_THREADS, ke.MIN_SLOTS, ke.MAX_SLOTS, ke.SLOTS_PER_MEMBER, ke.SEEDS,
        ke.CTL, ke.RAW)
    uns = {m[0]: int(m[1], 0) for m in re.findall(r"constexpr unsigned (\w+) = (0x[0-9A-Fa-f]+|\d+)u?;", src)}
    assert (uns["EMPTY"], uns["NARROW"], uns["MULT0"], uns["MULT_STEP"], uns["HASH_A"],
            uns["HASH_B"]) == (ke.EMPTY, ke.NARROW, ke.MULT0, ke.MULT_STEP, ke.HASH_A, ke.HASH_B)
    assert "__byte_perm(b, a, 0x5410)" in src  # the packed key: a << 16 | b


def _body(src: str, head: str) -> str:
    start = src.index(head)
    depth, i = 0, src.index("{", start)
    for j in range(i, len(src)):
        depth += {"{": 1, "}": -1}.get(src[j], 0)
        if depth == 0:
            return src[start: j + 1]
    raise AssertionError(head)


def test_barriers_of_a_pass():
    """The compaction holds two barriers (one after the published words,
    one after the writes); an a == b pass adds one for the last
    non-candidates, a pass with no live member has one. So a fused pass
    takes at most 2, an a == b pass at most 3."""
    src = CSRC.read_text()
    assert _body(src, "__device__ __forceinline__ int compact").count("__syncthreads()") == 2
    kernel = _body(src, "encode_rows_kernel(")
    loop = _body(kernel, "for (int p = 0; p < P; ++p)")
    parity = _body(loop, "if (mode == PARITY)")
    assert parity.count("__syncthreads()") == 1
    skip = _body(loop, "if (mode == SKIP)")
    assert skip.count("__syncthreads()") == 1
    assert loop.count("__syncthreads()") == 2


def test_the_kernel_source_launches_once_and_probes_independently():
    """One launch statement; the probe loop reads no kill bit; staging
    waits on its own cp.async copies; the note names the TPU kernel."""
    src = CSRC.read_text()
    assert src.count("<<<") == 1
    probe = _body(src, "__device__ __forceinline__ unsigned probe_perfect")
    assert "kill" not in probe
    assert "cp.async.wait_all" in _body(src, "__device__ void stage")
    assert "zigbpe_tpu/ops/pallas/encode.py::_encode_kernel" in src
    for suspect in ("STAGING OFF THE PASS", "TWO BARRIERS A PASS", "INDEPENDENT PROBES",
                    "ONE SHARED LOAD FOR A MISS", "NO SPILLS"):
        assert suspect in src


def test_replay_uses_random_fuzz_docs_of_the_jax_suite():
    """The fuzz docs of test_encode_fuzz.py drive the replay too."""
    r = np.random.default_rng(11)
    docs = _docs(r, 3)
    table = _adversarial_table(r, 12)
    gt, gl = ke.schedule_merges(np.asarray(table, np.int32), cap=8)
    got, lens = _agree(_batch(docs), gt, gl, 2, 2)
    assert [got[i, : lens[i]].tolist() for i in range(len(docs))] == [
        oracle.encode(d, table) for d in docs]
