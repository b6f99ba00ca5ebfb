"""The port's sort-based selection path (vocab > LAZY_VOCAB_MAX) against the
JAX package and the oracle on the same seeded numpy inputs: the selection
itself on both layouts, with ties and with ids above 46341, one chunk of
rounds, and whole training runs, checkpointed too. All comparisons are
exact."""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from zigbpe_tpu import train as j_train
from zigbpe_tpu.models import oracle
from zigbpe_tpu.ops import core as jcore
from zigbpe_tpu_torch import train as t_train
from zigbpe_tpu_torch.ops import core as tcore
from zigbpe_tpu_torch.ops.kernels import LAYOUT
from zigbpe_tpu_torch.ops.kernels import merge as kmerge


def _random(V, seed, lo=None, n=3000, cap=4096):
    """n ids drawn from a narrow range near the top of the vocab (many
    repeated pairs, so the counts tie often) in a PAD-tailed stream."""
    r = np.random.default_rng(seed)
    lo = V - 12 if lo is None else lo
    arr = np.full(cap, -1, np.int32)
    arr[:n] = r.integers(lo, V, n)
    return arr


def _ties(V, seed):
    """Six distinct pairs, five times each, separated by ids that occur
    once: six pairs tie at the top count and the largest must win."""
    r = np.random.default_rng(seed)
    pairs = r.choice(np.arange(V // 2, V), size=(6, 2), replace=False)
    seps = iter(range(1000, 1000 + 64))
    out = []
    for _ in range(5):
        for a, b in r.permutation(pairs):
            out += [int(a), int(b), next(seps) if len(out) < 180 else 999]
    arr = np.full(256, -1, np.int32)
    arr[: len(out)] = out
    return arr


def _row_local(V, seed):
    """A row-local layout as the merge kernel leaves it: rows of varying
    population after a pass of the twin (held to the JAX kernel in
    test_torch_merge_kernel.py)."""
    arr = _random(V, seed, lo=V - 5)
    toks = torch.from_numpy(arr)
    table = torch.tensor([[V - 5, V - 4, V - 1]], dtype=torch.int32)
    kmerge.merge_pass_multi_reference(toks, table)
    assert len(set((toks.view(-1, LAYOUT) >= 0).sum(1).tolist())) > 1
    return toks.numpy().copy()


STREAMS = {
    "random": lambda V: _random(V, 1),
    "ties": lambda V: _ties(V, 2),
    "row_local": lambda V: _row_local(V, 3),
    "one_token": lambda V: np.concatenate([[7], np.full(255, -1)]).astype(np.int32),
}


@pytest.mark.parametrize("V", [9000, 46341, 65536])
@pytest.mark.parametrize("stream", sorted(STREAMS))
@pytest.mark.parametrize("layout_block", [None, LAYOUT])
def test_select_top_pair_sorted_matches_jax(V, stream, layout_block):
    arr = STREAMS[stream](V)
    want = [int(x) for x in jcore.select_top_pair_sorted(
        jnp.asarray(arr), V, layout_block=layout_block)]
    got = [int(x) for x in tcore.select_top_pair_sorted(
        torch.from_numpy(arr), V, layout_block=layout_block)]
    if stream == "one_token":  # no pair: count 0, first and second meaningless
        got, want = got[2:], want[2:]
        assert want == [0]
    assert got == want
    if stream == "ties":
        assert want[2] == 5
    if stream != "one_token" and V > 46341:
        assert want[0] > 46341  # ids past the int32 packing limit


def _chunk_state(V, k0, lo, seed):
    r = np.random.default_rng(seed)
    arr = np.full(4096, -1, np.int32)
    arr[:3000] = r.integers(lo, lo + 6, 3000)
    M = V - 256
    merges = np.full((M, 3), -1, np.int32)
    merges[:k0] = 1  # stands for earlier merges; never read
    return arr, merges, np.zeros(M, np.int32)


@pytest.mark.parametrize("V,k0,rounds,lo", [
    (9000, 0, 24, 97),            # a chunk of rounds at a fresh start
    (65536, 65536 - 256 - 20, 32, 65000),  # wide ids; stops at the target vocab
])
def test_train_chunk_matches_jax(V, k0, rounds, lo):
    arr, merges, occ = _chunk_state(V, k0, lo, seed=V)
    jt, jl, jm, jo, jk, _ = jcore.train_chunk(
        jnp.asarray(arr), jnp.int32(3000), jnp.asarray(merges), jnp.asarray(occ),
        jnp.int32(k0), vocab_size=V, max_rounds=rounds, use_pallas=False,
    )
    tt, tl, tm, to, tk, flag = tcore.train_chunk(
        torch.from_numpy(arr.copy()), 3000, torch.from_numpy(merges.copy()),
        torch.from_numpy(occ.copy()), k0, vocab_size=V, max_rounds=rounds,
    )
    assert tk == int(jk) == min(k0 + rounds, V - 256) and flag == 0
    assert tl == int(jl)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    jt = np.asarray(jt)
    tt = tt.numpy()
    assert tt[tt >= 0].tolist() == jt[jt >= 0].tolist()


_EARLY = bytes(np.random.default_rng(33).integers(97, 101, 600, dtype=np.uint8))
_TEXT = (Path(__file__).parent / "data" / "taylorswift.txt").read_bytes()[:400]


@pytest.mark.parametrize("data,kw", [
    (_EARLY, {}),                    # early stop
    (_TEXT, {"chunk_rounds": 16}),   # many chunks, shrink and recompaction
], ids=["early_stop", "chunks"])
def test_train_sorted_matches_jax_and_oracle(data, kw, capsys):
    assert 9000 > t_train.LAZY_VOCAB_MAX
    want = oracle.train(data, 9000)
    capsys.readouterr()
    got = t_train.train(data, 9000, device="cpu", **kw)
    assert "Stopping early" in capsys.readouterr().out
    assert got == want
    assert got == j_train.train(data, 9000, **kw)
    assert len(got) > 200  # the sorted path did real selection work


def test_train_sorted_with_checkpoint(tmp_path):
    """The checkpointed sorted run equals the oracle's and the JAX
    trainer's, and its last checkpoint holds the finished state."""
    from zigbpe_tpu_torch.utils import checkpoint

    want = oracle.train(_TEXT, 9000)
    got = t_train.train(_TEXT, 9000, device="cpu", checkpoint_dir=str(tmp_path / "t"),
                        checkpoint_every_chunks=1, chunk_rounds=16)
    assert got == want
    assert got == j_train.train(_TEXT, 9000, checkpoint_dir=str(tmp_path / "j"),
                                checkpoint_every_chunks=1, chunk_rounds=16)
    merges, toks, vocab, occ = checkpoint.load(tmp_path / "t")
    assert vocab == 9000 and merges == want  # saved after the last chunk too
    assert toks.tolist() == oracle.encode(_TEXT, merges)


def test_train_sorted_verbose_matches_oracle(capsys):
    data = _TEXT[:200]
    t_train.train(data, 9000, verbose=True, device="cpu")
    port = capsys.readouterr().out
    oracle.train(data, 9000, verbose=True)
    # the oracle stops without the trainers' early-stop notice
    assert port == capsys.readouterr().out + "No more pairs to merge. Stopping early.\n"
    assert port.count("occurrences") > 100
