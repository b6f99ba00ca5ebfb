"""The port's data-parallel trainer (``zigbpe_tpu_torch.parallel.train_dp``)
against the oracle and the JAX trainer (``zigbpe_tpu.parallel.train_dp``),
mirroring tests/test_parallel.py: every rank is a process of a gloo group on
the CPU (tests/torch_dp_ranks.py), one group per world size, running all of
that size's cases; world size 1 runs in this process without a group.
The ub seeds and the single-shard merges are held against the JAX
functions under ``jax.shard_map`` on the 8-device CPU mesh (the Pallas
merge in interpret mode). All comparisons are exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from tests import torch_dp_ranks as ranks
from zigbpe_tpu.models import oracle
from zigbpe_tpu.parallel import train_dp as jdp
from zigbpe_tpu_torch.parallel import train_dp as dp

TEXT = (b"the quick brown fox jumps over the lazy dog " * 100, 300)
RANDOM = (bytes(np.random.default_rng(3).integers(97, 103, 4096, dtype=np.uint8)), 310)
# long single-byte runs across shard boundaries: the global parity carry
SPANNING = (b"a" * 1000 + b"b" + b"a" * 1000 + b"bb" + b"a" * 500, 280)
# pairs repeatedly straddle the boundaries of ragged shards
BOUNDARY = (bytes(np.random.default_rng(4).integers(97, 99, 257, dtype=np.uint8)), 300)
TINY = (b"aaab", 300)  # fewer bytes than ranks: some start empty
INVARIANT = (bytes(np.random.default_rng(5).integers(32, 127, 2000, dtype=np.uint8)), 290)
HELLO = b"hello world hello " * 64
EARLY = (b"ab" * 2, 400)
# shards of 32768 tokens (the JAX Pallas test's capacity): a cross-boundary
# merge, and a == b rounds whose runs span ranks
KERNEL = (bytes(np.random.default_rng(11).integers(97, 103, 40000, dtype=np.uint8)), 290, 16)
PARITY = (b"a" * 9000 + b"bc" * 600 + b"a" * 7000, 272, 8)

NAMED = {"text": TEXT, "random": RANDOM, "spanning": SPANNING, "boundary": BOUNDARY,
         "tiny": TINY, "invariant": INVARIANT, "early": EARLY}
UB = (bytes(np.random.default_rng(13).integers(0, 256, 3000, dtype=np.uint8)), 300)


def _train(data, vocab, **kw):
    return dict(kind="train", data=data, vocab=vocab, **kw)


def _row_local_shards(seed: int, D: int, cap: int, empty=()):
    """Seeded shards in the kernel's row-local layout over the letters
    a, b, c (each row a random prefix, no interior row empty), with
    boundary pairs (a, b) forced across ranks 0 -> 1 and across an empty
    rank, and a rank whose row 0 holds only [b, x]."""
    rng = np.random.default_rng(seed)
    shards = []
    for d in range(D):
        buf = np.full(cap, -1, np.int32)
        if d not in empty:
            nrows = int(rng.integers(1, cap // 128 + 1))
            for r in range(nrows):
                k = int(rng.integers(1, 129))
                buf[r * 128: r * 128 + k] = rng.integers(97, 100, k)
        shards.append(buf)
    last = [int(np.flatnonzero(s >= 0)[-1]) if (s >= 0).any() else None for s in shards]
    shards[0][last[0]] = 97
    shards[1][0] = 98
    shards[1][last[1]] = 97
    shards[D - 1][:128] = -1
    shards[D - 1][:2] = [98, 99]
    if not (shards[D - 1][128:] >= 0).any():
        shards[D - 1][128:130] = [97, 97]
    return shards


def _prefix_shards(seed: int, D: int, cap: int, empty=()):
    """Seeded prefix-layout shards of long a runs broken by b."""
    rng = np.random.default_rng(seed)
    shards = []
    for d in range(D):
        buf = np.full(cap, -1, np.int32)
        if d not in empty:
            k = int(rng.integers(1, cap + 1))
            buf[:k] = np.where(rng.random(k) < 0.08, 98, 97)
        shards.append(buf)
    return shards


AB_SHARDS = _row_local_shards(21, 4, 32768, empty=(2,))
AA_SHARDS = _prefix_shards(22, 4, 256, empty=(1,))
AB_PAIR, AA_PAIR = (97, 98, 300), (97, 97, 300)

CASES_8 = {name: _train(d, v) for name, (d, v) in NAMED.items()}
CASES_8["chunk3"] = _train(HELLO, 300, kwargs=dict(chunk_rounds=3))
CASES_8["chunk64"] = _train(HELLO, 300, kwargs=dict(chunk_rounds=64))
CASES_8["kernel"] = _train(KERNEL[0], KERNEL[1], per_shard_capacity=32768,
                           kwargs=dict(chunk_rounds=KERNEL[2]))
CASES_8["parity"] = _train(PARITY[0], PARITY[1], per_shard_capacity=32768,
                           kwargs=dict(chunk_rounds=PARITY[2]))
CASES_8["init_ub"] = dict(kind="init_ub", data=UB[0], vocab=UB[1])
CASES_4 = {"invariant": _train(*INVARIANT), "spanning": _train(*SPANNING),
           "merge_ab": dict(kind="merge", shards=AB_SHARDS, pair=AB_PAIR),
           "merge_aa": dict(kind="merge", shards=AA_SHARDS, pair=AA_PAIR)}
CASES_2 = {"invariant": _train(*INVARIANT), "parity": CASES_8["parity"]}


def _spawn(world, cases):
    results = ranks.run(world, list(cases.values()), timeout=150)
    return {name: [r[i] for r in results] for i, name in enumerate(cases)}


@pytest.fixture(scope="module")
def ranks8():
    return _spawn(8, CASES_8)


@pytest.fixture(scope="module")
def ranks4():
    return _spawn(4, CASES_4)


@pytest.fixture(scope="module")
def ranks2():
    return _spawn(2, CASES_2)


def mesh_of(n):
    return jdp.data_mesh(np.asarray(jax.devices()[:n]))


def _same_on_every_rank(per_rank):
    assert all(r == per_rank[0] for r in per_rank), "ranks disagree"
    return per_rank[0]


def test_shard_corpus_layout():
    # 100 bytes over 8 shards -> 13 per shard (the last has 9), as the JAX
    # placement of the same bytes
    data = bytes(range(100))
    want = np.asarray(jdp.shard_corpus(data, mesh_of(8), per_shard_capacity=256)).reshape(8, 256)
    for r in range(8):
        start, end, cap = dp.shard_range(len(data), r, 8, per_shard_capacity=256)
        assert cap == 256 and (start, end) == (min(13 * r, 100), min(13 * r + 13, 100))
        got = dp.core.pad_tokens(data[start:end], cap, "cpu")[0].numpy()
        assert np.array_equal(got, want[r])
    assert dp.shard_range(1000, 0, 8) == (0, 125, dp.MIN_SHARD_CAPACITY)
    with pytest.raises(ValueError, match="multiple of 128"):
        dp.shard_range(100, 0, 8, per_shard_capacity=200)


@pytest.mark.parametrize("name", sorted(NAMED))
def test_dp8_matches_oracle(ranks8, name):
    data, vocab = NAMED[name]
    assert _same_on_every_rank(ranks8[name]) == oracle.train(data, vocab)


def test_dp8_matches_jax_dp(ranks8):
    data, vocab = TEXT
    assert _same_on_every_rank(ranks8["text"]) == jdp.train_dp(data, vocab, mesh=mesh_of(8))


def test_dp_chunking_invariance(ranks8):
    a = _same_on_every_rank(ranks8["chunk3"])
    assert a == _same_on_every_rank(ranks8["chunk64"]) == oracle.train(HELLO, 300)


@pytest.mark.parametrize("name,case", [("kernel", KERNEL), ("parity", PARITY)])
def test_dp8_kernel_capacity_matches_oracle(ranks8, name, case):
    data, vocab, _ = case
    assert _same_on_every_rank(ranks8[name]) == oracle.train(data, vocab)


@pytest.mark.parametrize("world", [1, 2, 4, 8])
def test_dp_world_size_invariance(world, request):
    data, vocab = INVARIANT
    if world == 1:
        got = dp.train_dp(data, vocab, device="cpu")
    else:
        got = _same_on_every_rank(request.getfixturevalue(f"ranks{world}")["invariant"])
    assert got == oracle.train(data, vocab)


def test_dp4_spanning_runs(ranks4):
    data, vocab = SPANNING
    assert _same_on_every_rank(ranks4["spanning"]) == oracle.train(data, vocab)


def test_dp2_parity_runs_match_jax_dp(ranks2):
    data, vocab, rounds = PARITY
    got = _same_on_every_rank(ranks2["parity"])
    assert got == oracle.train(data, vocab)
    assert got == jdp.train_dp(data, vocab, mesh=mesh_of(2), chunk_rounds=rounds)


def test_init_ub_matches_jax(ranks8):
    data, V = UB
    want = np.asarray(jdp._init_ub_jit(jdp.shard_corpus(data, mesh_of(8)), vocab_size=V,
                                       mesh=mesh_of(8)))
    for table in ranks8["init_ub"]:
        assert np.array_equal(table, want)


def _jax_shard_merge(shards, pair, kernel: bool):
    """The JAX shard merge on the same shards, under shard_map: per-shard
    outputs stacked in rank order."""
    D = len(shards)
    ta, tb, new = pair
    if kernel:
        def body(t):
            out, h, k, bad = jdp._pallas_merge_shard(t, ta, tb, new, True)
            return out, h.reshape(1), k.reshape(1), bad.reshape(1).astype(jnp.int32)
    else:
        def body(t):
            out, h, k = jdp._xla_merge_shard(t, ta, tb, new)
            return out, h.reshape(1), k.reshape(1), jnp.zeros((1,), jnp.int32)
    fn = jax.jit(jax.shard_map(body, mesh=mesh_of(D), in_specs=(P("data"),),
                               out_specs=(P("data"),) * 4, check_vma=False))
    out, h, k, bad = (np.asarray(x) for x in fn(jnp.asarray(np.concatenate(shards))))
    return out.reshape(D, -1), np.stack([h, k, bad], 1)


@pytest.mark.parametrize("name,shards,pair,kernel", [
    ("merge_ab", AB_SHARDS, AB_PAIR, True),
    ("merge_aa", AA_SHARDS, AA_PAIR, False),
])
def test_shard_merge_matches_jax(ranks4, name, shards, pair, kernel):
    want_out, want_stats = _jax_shard_merge(shards, pair, kernel)
    for r, (out, stats) in enumerate(ranks4[name]):
        assert np.array_equal(out, want_out[r]), f"rank {r}"
        assert stats == want_stats[r].tolist(), f"rank {r}"
    if kernel:  # the last rank's head was killed across the empty rank
        assert ranks4[name][-1][1][2] == 1


def test_prefix_max_matches_cummax():
    import torch

    rng = np.random.default_rng(9)
    for n in (1, 127, 128, 129, 128 * 128 + 5, 3 * 128 * 128):
        x = torch.from_numpy(rng.integers(-5, 10**6, n))
        assert torch.equal(dp._prefix_max(x), torch.cummax(x, 0).values)
