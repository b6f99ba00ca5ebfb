"""The port's trainer against the JAX trainer, the NumPy backend and the
golden merge table. Both packages start from the same state (numpy arrays
carried by zigbpe_tpu_torch.utils.state); all comparisons are exact.

The ub tables are not compared: top-k ties may order the verify sets
differently in the two frameworks, which changes bounds but never the
merges, occupancies, k, length or logical stream.
"""

from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
from zigbpe_tpu import train as j_train
from zigbpe_tpu.models import numpy_backend, oracle
from zigbpe_tpu.ops import core as jcore
from zigbpe_tpu_torch import BasicTokenizer
from zigbpe_tpu_torch import train as t_train
from zigbpe_tpu_torch.ops import core as tcore
from zigbpe_tpu_torch.utils.state import TrainState

REPO = Path(__file__).resolve().parents[1]


def _chained_state():
    """Fresh byte corpus at vocab 300: chained group extensions."""
    r = np.random.default_rng(6)
    data = bytes(r.integers(97, 103, 4000, dtype=np.uint8))
    V = 300
    arr, n = jcore.pad_tokens(data, 4096)
    ub = jcore.pair_histogram(arr, V)
    M = V - 256
    return V, (np.asarray(arr), int(n), np.asarray(ub), np.full((M, 3), -1, np.int32),
               np.zeros(M, np.int32), 0)


def _membership_state():
    """Resumed mid-training at vocab 1066 of 1100: membership extensions
    (the test_deep_vocab_lazy_membership_mode set-up)."""
    r = np.random.default_rng(7)
    data = bytes(r.integers(32, 127, 16000, dtype=np.uint8))
    V = 1100
    want = numpy_backend.train(data, V)
    prefix = want[:810]
    stream = np.asarray(numpy_backend.encode(data, prefix), np.int32)
    arr, n = jcore.pad_token_ids(stream, 16384)
    ub = jcore.pair_histogram(arr, V)
    M = V - 256
    merges = np.full((M, 3), -1, np.int32)
    merges[:810] = np.asarray(prefix, np.int32)
    return V, (np.asarray(arr), int(n), np.asarray(ub), merges, np.zeros(M, np.int32), 810)


@pytest.mark.parametrize("mode,make,rounds", [
    ("chained", _chained_state, 16),
    ("membership", _membership_state, 16),
])
def test_train_chunk_lazy_matches_jax(mode, make, rounds):
    V, (arr, n, ub, merges, occ, k0) = make()
    jt, jl, _, jm, jo, jk, _ = jcore.train_chunk_lazy(
        jnp.asarray(arr), jnp.int32(n), jnp.asarray(ub), jnp.asarray(merges),
        jnp.asarray(occ), jnp.int32(k0), vocab_size=V, max_rounds=rounds,
        use_pallas=False, select_batch=8 if V <= 1024 else 32, merge_group=4,
    )
    st = TrainState.from_numpy(arr, n, ub, merges, occ, k0)
    assert (V <= 1024) == (mode == "chained")
    tt, tl, _, tm, to, tk, flag = tcore.train_chunk_lazy(
        st.tokens, st.length, st.ub, st.merges, st.occupancy, st.k, vocab_size=V,
        max_rounds=rounds, select_batch=8 if V <= 1024 else 32, merge_group=4,
    )
    jk = int(jk)
    assert tk == jk == k0 + rounds and flag == 0
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(to.numpy()[:jk], np.asarray(jo)[:jk])
    jt = np.asarray(jt)
    tt = tt.numpy()
    assert tl == int(jl)
    assert tt[tt >= 0].tolist() == jt[jt >= 0].tolist()


_CASES = {
    # test_train_device_matches_host
    "random_5000_v320": (bytes(np.random.default_rng(7).integers(32, 127, 5000, dtype=np.uint8)),
                         320, {}),
    # test_train_chunking_and_shrink
    "quick_fox_chunk5": (b"the quick brown fox jumps over the lazy dog " * 200, 300,
                         {"chunk_rounds": 5}),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_train_matches_jax_and_host(case):
    data, V, kw = _CASES[case]
    got = t_train.train(data, V, device="cpu", **kw)
    assert got == j_train.train(data, V, **kw)
    assert got == numpy_backend.train(data, V)


def test_train_early_stop_matches_oracle(capsys):
    data = b"abcabcabc"
    got = t_train.train(data, 300, device="cpu")
    assert got == oracle.train(data, 300)
    assert "Stopping early" in capsys.readouterr().out


def test_train_verbose_format_matches_reference(capsys):
    # the reference's per-merge line (basic_tokenizer.zig:308-317), as the
    # oracle and the JAX trainer print it
    data = b"hello world hello " * 30
    t_train.train(data, 270, verbose=True, device="cpu")
    port = capsys.readouterr().out
    oracle.train(data, 270, verbose=True)
    assert port == capsys.readouterr().out
    assert port.count("occurrences") == 14


def test_train_shrinks_capacity():
    # 40,000 bytes start at capacity 65536; merges compact the stream below
    # 32768 tokens, so the trainer recompacts and halves the capacity
    data = (b"ab" * 10000) + (b"cd" * 10000)
    assert t_train._round_capacity(len(data)) == 65536
    assert t_train.train(data, 262, chunk_rounds=1, device="cpu") == oracle.train(data, 262)


@pytest.mark.parametrize("kw", [
    {"checkpoint_dir": "ck"}, {"detailed_stats": True},
    {"vocab_size": t_train.LAZY_VOCAB_MAX + 1},
])
def test_train_unported_options_raise(kw, tmp_path):
    """The options that once raised NotImplementedError (a checkpoint
    directory, the detailed split, a vocab past LAZY_VOCAB_MAX) now train
    to the oracle's merges."""
    data = b"hello world, hello there " * 20
    kw = dict(kw)
    vocab = kw.pop("vocab_size", 300)
    if "checkpoint_dir" in kw:
        kw["checkpoint_dir"] = str(tmp_path / kw["checkpoint_dir"])
    assert t_train.train(data, vocab, device="cpu", **kw) == oracle.train(data, vocab)


@pytest.mark.parametrize("vocab", [300, 9000], ids=["lazy", "sorted"])
def test_detailed_stats_matches_jax(vocab, capsys):
    """The instrumented per-round loop gives the chunk loop's merges and
    the JAX trainer's phase names: count_pairs (the ub seed, lazy only),
    sort_pairs and replace_pairs."""
    from zigbpe_tpu.utils.profiling import TimeStats as JStats
    from zigbpe_tpu_torch.utils.profiling import TimeStats

    data = (REPO / "tests" / "data" / "taylorswift.txt").read_bytes()[:2000]
    if vocab > t_train.LAZY_VOCAB_MAX:
        data = data[:300]
    want = oracle.train(data, vocab)
    ts, js = TimeStats(), JStats()
    got = t_train.train(data, vocab, detailed_stats=True, stats=ts, device="cpu")
    assert got == want == t_train.train(data, vocab, device="cpu")
    assert j_train.train(data, vocab, detailed_stats=True, stats=js) == want
    assert list(ts.phases) == list(js.phases)
    assert "sort_pairs" in ts.phases and "replace_pairs" in ts.phases
    assert ("count_pairs" in ts.phases) == (vocab <= t_train.LAZY_VOCAB_MAX)
    assert ts.phases["replace_pairs"].calls == len(want)


def test_golden_merges_on_cpu(corpus_bytes, golden_merges):
    """The port's CPU training of the conformance corpus reproduces the
    reference's merges.txt (44 merges, one golden tie)."""
    tok = BasicTokenizer(device="cpu").train(corpus_bytes, 300)
    assert tok.merges == golden_merges
