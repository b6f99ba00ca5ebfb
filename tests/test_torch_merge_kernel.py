"""The port's merge pass (plain PyTorch twin of the CUDA kernel) against the
JAX Pallas merge kernel in interpret mode, on every case of
test_pallas_merge.py.

Both take the same numpy input. All values are integers, so every
comparison is exact: the output arrays are equal element for element (both
use 128-token rows), stats[:K+1] are equal, and the min_kept <= 1 decision
agrees (the JAX kernel folds min_kept only over the blocks it processes).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from zigbpe_tpu.models import oracle
from zigbpe_tpu.ops import core as jcore
from zigbpe_tpu.ops.pallas import merge as pm
from zigbpe_tpu_torch.ops import core as tcore
from zigbpe_tpu_torch.ops.kernels import merge as kmerge


def _input(data: bytes, cap: int) -> np.ndarray:
    arr, _ = jcore.pad_tokens(data, cap)
    return np.asarray(arr)


def _agree(arr: np.ndarray, table) -> tuple[np.ndarray, np.ndarray]:
    """One pass through both kernels; returns the (equal) output and the
    port's stats."""
    table = np.asarray(table, np.int32).reshape(-1, 3)
    K = table.shape[0]
    jout, jstats = pm.merge_pass_pallas_multi(
        jnp.asarray(arr), jnp.asarray(table), block_rows=8, interpret=True
    )
    jout, jstats = np.asarray(jout), np.asarray(jstats)
    t = torch.from_numpy(arr.copy())
    tout, tstats = kmerge.merge_pass_multi(t, torch.from_numpy(table))
    assert tout.data_ptr() == t.data_ptr()  # in place
    tout, tstats = tout.numpy(), tstats.numpy()
    np.testing.assert_array_equal(tout, jout)
    assert tstats[: K + 1].tolist() == jstats[: K + 1].tolist()
    assert (tstats[K + 1] <= 1) == (jstats[K + 1] <= 1)
    return tout, tstats


def _logical(arr: np.ndarray) -> list:
    return arr[arr >= 0].tolist()


_rng = np.random.default_rng(0)
_edge = bytearray(np.random.default_rng(1).integers(99, 103, 4096, dtype=np.uint8))
_edge[1023], _edge[1024] = 97, 98
_medge = bytearray(np.random.default_rng(2).integers(101, 104, 4096, dtype=np.uint8))
_medge[1023], _medge[1024], _medge[2047], _medge[2048] = 97, 98, 99, 100

SINGLE_PASS = {
    # small vectors
    "aaa": (b"aaa", [(97, 97, 256)], 1024),
    "aaaa": (b"aaaa", [(97, 97, 256)], 1024),
    "abab": (b"abab", [(97, 98, 256)], 1024),
    "xay": (b"xay", [(97, 98, 256)], 1024),
    "empty": (b"", [(97, 98, 256)], 1024),
    "a": (b"a", [(97, 97, 256)], 1024),
    # random data, one and several blocks
    "single_block_ab": (bytes(_rng.integers(97, 100, 900, dtype=np.uint8)), [(97, 98, 256)], 1024),
    "single_block_aa": (bytes(_rng.integers(97, 100, 900, dtype=np.uint8)), [(97, 97, 256)], 1024),
    "multi_block_ab": (bytes(_rng.integers(97, 100, 4000, dtype=np.uint8)), [(97, 98, 256)], 4096),
    "multi_block_aa": (bytes(_rng.integers(97, 100, 4000, dtype=np.uint8)), [(97, 97, 256)], 4096),
    "run_spanning_blocks": (b"a" * 3000, [(97, 97, 256)], 4096),
    "pair_at_block_edge": (bytes(_edge), [(97, 98, 256)], 4096),
    "heavy_compaction": (b"ab" * 2000, [(97, 98, 256)], 4096),
    # multi-slot groups
    "multi_two_disjoint": (b"abcdabcdxy", [(97, 98, 256), (99, 100, 257)], 1024),
    "multi_shared_left": (b"ab ac ab ac", [(97, 98, 256), (97, 99, 257)], 1024),
    "multi_shared_right": (b"xa ya xa", [(120, 97, 256), (121, 97, 257)], 1024),
    "multi_disabled": (b"abab", [(97, 98, 256), (-2, -2, -2), (-2, -2, -2)], 1024),
    "multi_parity_slot0": (b"aaaxyxy", [(97, 97, 256), (120, 121, 257)], 1024),
    "multi_cross_block": (bytes(_medge), [(97, 98, 256), (99, 100, 257)], 4096),
}


@pytest.mark.parametrize("case", sorted(SINGLE_PASS))
def test_single_pass_matches_jax_kernel(case):
    data, table, cap = SINGLE_PASS[case]
    out, stats = _agree(_input(data, cap), table)
    want = list(data)
    for a, b, x in table:
        if a >= 0:
            want = oracle.merge_pass(want, a, b, x)
    assert _logical(out) == want
    assert int(stats[len(table)]) == len(want)


@pytest.mark.parametrize("data,pair", [(b"aaaaa", (97, 97)), (b"abcab" * 300, (97, 98))])
def test_single_pair_wrapper_matches_jax_kernel(data, pair):
    arr = _input(data, 2048)
    jout, jstats = pm.merge_pass_pallas(jnp.asarray(arr), *pair, 256, block_rows=8,
                                        interpret=True)
    tout, tstats = kmerge.merge_pass(torch.from_numpy(arr.copy()), *pair, 256)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    assert tstats[:2].tolist() == np.asarray(jstats)[:2].tolist()


@pytest.mark.parametrize("seed", range(10))
def test_random_chain_free_group_matches_jax_kernel(seed):
    r = np.random.default_rng(seed)
    data = bytes(r.integers(97, 105, 3000, dtype=np.uint8))
    toks = list(range(97, 105))
    r.shuffle(toks)
    table = [(toks[2 * i], toks[2 * i + 1], 256 + i) for i in range(4)]
    out, _ = _agree(_input(data, 4096), table)
    want = list(data)
    for a, b, x in table:
        want = oracle.merge_pass(want, a, b, x)
    assert _logical(out) == want


def test_row_local_layout_roundtrip():
    data = b"abcabc" * 600
    mid, _ = _agree(_input(data, 4096), [(97, 98, 256)])
    out, stats = _agree(mid, [(256, 99, 257)])
    want = oracle.merge_pass(oracle.merge_pass(list(data), 97, 98, 256), 256, 99, 257)
    assert _logical(out) == want
    assert int(stats[1]) == len(want)


def test_min_kept_flags_draining_interior_rows():
    data = b"a" * 1024 + b"bcd" * 400
    out = _input(data, 4096)
    stream, tok, flagged = list(data), 97, 0
    for r in range(10):
        out, stats = _agree(out, [(tok, tok, 256 + r)])
        stream = oracle.merge_pass(stream, tok, tok, 256 + r)
        assert _logical(out) == stream
        if int(stats[2]) <= 1:
            flagged += 1
            out, _ = tcore.compact_stream(torch.from_numpy(out))
            out = out.numpy()
        tok = 256 + r
    assert flagged > 0


def test_min_kept_ignores_last_nonempty_row():
    out = _input(b"c" * 128 + b"a" * 128, 1024)
    tok = 97
    for r in range(7):
        out, stats = _agree(out, [(tok, tok, 256 + r)])
        assert int(stats[2]) > 1, "tail drain must not flag"
        tok = 256 + r
    assert int((out.reshape(-1, 128)[1] >= 0).sum()) == 1


def _drain_layout(idle: bool) -> np.ndarray:
    arr = np.full((16, 128), -1, np.int32)
    arr[:7] = 99
    arr[7, :2] = 97
    arr[8:] = 100
    if idle:
        arr[8:, ::2] = 97  # 'a' present in block 1, never "aa"
    return arr.reshape(-1)


@pytest.mark.parametrize("idle", [False, True], ids=["skipped", "idle"])
def test_min_kept_folds_deferred_row(idle):
    arr = _drain_layout(idle)
    out, stats = _agree(arr, [(97, 97, 256)])
    assert _logical(out) == oracle.merge_pass(_logical(arr), 97, 97, 256)
    assert int(stats[2]) == 1


def test_encode_replay_recompacts_drained_interior_blocks():
    B = 256 * 128
    data = b"a" * (2 * B) + b"cd" * 64
    merges = [(97, 97, 256)] + [(256 + i, 256 + i, 257 + i) for i in range(15)]
    merges.append((271, 99, 272))
    marr = np.asarray(merges, np.int32)
    arr = _input(data, 3 * B)
    jout, jlen = jcore.encode_replay(
        jnp.asarray(arr), jnp.asarray(marr), use_pallas=True, interpret=True
    )
    tout, tlen = tcore.encode_replay(torch.from_numpy(arr.copy()), torch.from_numpy(marr))
    assert tlen == int(jlen)
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    got = tout.numpy()[:tlen].tolist()
    assert got == oracle.encode(data, merges)
    assert got[0] == 272
