"""The host-side seed of the upper-bound table in the port
(``zigbpe_tpu_torch.train``: ``upload``, ``_place_byte_hist``, the seed of
``train``; ``zigbpe_tpu_torch.parallel.train_dp``: ``_host_pair_entries``,
``_byte_pair_entries`` and the two placements) against the JAX package's
and the device seed, and the phases it puts in ``TimeStats`` against the
JAX trainer's and the JAX CLI's. Every comparison is exact: tables, merges,
phase names and call counts are integers and names."""

import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_dp_ranks as ranks
from zigbpe_tpu import cli as j_cli
from zigbpe_tpu import train as j_train
from zigbpe_tpu.models import oracle
from zigbpe_tpu.parallel import train_dp as jdp
from zigbpe_tpu.utils.profiling import TimeStats as JStats
from zigbpe_tpu_torch import cli
from zigbpe_tpu_torch import train as t_train
from zigbpe_tpu_torch.ops import core
from zigbpe_tpu_torch.parallel import train_dp as dp
from zigbpe_tpu_torch.utils.profiling import TimeStats

RANDOM = bytes(np.random.default_rng(21).integers(0, 256, 3000, dtype=np.uint8))
TEXT = b"the quick brown fox jumps over the lazy dog, hello world hello " * 40
# the edge inputs the port is held to (empty, one byte, all equal, every byte
# value), and vocab sizes from 255 to 600
EDGES = {
    "empty": (b"", 300),
    "one_byte": (b"x", 300),
    "all_equal": (b"a" * 1000, 300),
    "all_bytes": (bytes(range(256)) * 4, 300),
    "v256": (TEXT, 256),
    "v257": (TEXT, 257),
    "v600": (TEXT, 600),
}


def _calls(stats, chunks: bool = True) -> dict:
    """{phase: calls}, in the order the phases first ran; without
    ``merge_rounds`` unless ``chunks``. A chunk of the port ends early when
    a merge pass drains a row of the kernel's layout (to recompact it), as
    the JAX trainer's Pallas path does on a TPU; its XLA path, which these
    tests run on the CPU, never does. So on inputs that drain a row the
    chunk counts differ, and nothing else does."""
    return {name: acc.calls for name, acc in stats.phases.items()
            if chunks or name != "merge_rounds"}


def mesh_of(n: int):
    return jdp.data_mesh(np.asarray(jax.devices()[:n]))


def test_upload_returns_the_jax_seed_block():
    tokens, n, block = t_train.upload(RANDOM, "cpu")
    jt, jn, jblock = j_train.upload(RANDOM)
    assert n == int(jn) == len(RANDOM)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jt))
    assert block.dtype == torch.int32 and block.device.type == "cpu"
    np.testing.assert_array_equal(block.numpy(), np.asarray(jblock))


def test_upload_times_staging_and_seed_like_jax():
    ts, js = TimeStats(), JStats()
    t_train.upload(RANDOM, "cpu", ts)
    j_train.upload(RANDOM, js)
    assert _calls(ts) == _calls(js) == {"initial_tokens": 1, "count_pairs": 1}


@pytest.mark.parametrize("vocab", [257, 300, 512, 4096])
def test_placed_seed_equals_the_device_histogram(vocab):
    """The host seed placed in the V*V table equals core.pair_histogram of
    the uploaded stream, and JAX's placement of the same block."""
    tokens, _, block = t_train.upload(RANDOM, "cpu")
    placed = t_train._place_byte_hist(block, vocab)
    assert placed.shape == (vocab * vocab,) and placed.dtype == torch.int32
    assert torch.equal(placed, core.pair_histogram(tokens, vocab))
    want = j_train._place_byte_hist(jnp.asarray(block.numpy()), vocab_size=vocab)
    np.testing.assert_array_equal(placed.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", sorted(EDGES))
def test_train_with_the_host_seed_matches_jax_and_oracle(case):
    data, vocab = EDGES[case]
    ts, js = TimeStats(), JStats()
    got = t_train.train(data, vocab, device="cpu", stats=ts)
    assert got == j_train.train(data, vocab, stats=js) == oracle.train(data, vocab)
    assert list(ts.phases) == list(js.phases)
    assert _calls(ts, chunks=False) == _calls(js, chunks=False)
    if len(data) >= 2 and vocab > 256:
        assert ts.phases["count_pairs"].calls == 2  # the host count, then its placement


def test_vocab_below_256_raises_like_jax():
    for fn in (lambda: t_train.train(TEXT, 255, device="cpu"), lambda: j_train.train(TEXT, 255)):
        with pytest.raises(ValueError, match="256"):
            fn()


def test_train_device_seeds_from_the_block_or_the_stream():
    """train_device gives the same merges with the upload's seed block and
    without one (then it counts the stream on the device)."""
    want = oracle.train(TEXT, 300)
    tokens, n, block = t_train.upload(TEXT, "cpu")
    assert t_train.train_device(tokens, n, 300, ub_seed_block=block) == want
    tokens, n, _ = t_train.upload(TEXT, "cpu")
    assert t_train.train_device(tokens, n, 300) == want


def _jax_checkpoint(tmp_path):
    """A JAX checkpoint of TEXT at vocab 300 taken midway (merge 40 of 44)."""
    ck = tmp_path / "jax_ck"
    j_train.train(TEXT, 300, chunk_rounds=4, checkpoint_dir=str(ck), checkpoint_every_chunks=2)
    return ck


@pytest.mark.parametrize("mode", ["chunked", "detailed", "resumed", "sorted"])
def test_time_stats_match_jax(mode, tmp_path):
    """TimeStats phase names (in order) and call counts equal the JAX
    trainer's: chunked, detailed (the host seed computed, then the table
    counted on the device), resumed from a checkpoint (no host seed) and
    past LAZY_VOCAB_MAX (no seed at all; its corpus drains a row, so the
    chunk counts are left out there)."""
    vocab = 9000 if mode == "sorted" else 300
    data = TEXT[:400] if mode == "sorted" else TEXT
    kw = {"detailed_stats": True} if mode == "detailed" else {}
    tkw, jkw = dict(kw), dict(kw)
    if mode == "resumed":
        ck = _jax_checkpoint(tmp_path)
        shutil.copytree(ck, tmp_path / "port_ck")
        tkw["checkpoint_dir"], jkw["checkpoint_dir"] = str(tmp_path / "port_ck"), str(ck)
    ts, js = TimeStats(), JStats()
    got = t_train.train(data, vocab, device="cpu", stats=ts, **tkw)
    assert got == j_train.train(data, vocab, stats=js, **jkw) == oracle.train(data, vocab)
    assert list(ts.phases) == list(js.phases)
    assert _calls(ts, chunks=mode != "sorted") == _calls(js, chunks=mode != "sorted")
    want_seeds = {"chunked": 2, "detailed": 2, "resumed": 1, "sorted": 0}[mode]
    assert _calls(ts).get("count_pairs", 0) == want_seeds


_REPORT_LINE = re.compile(r"^\s+(\w+): [\d.]+ ms total, (\d+) calls")


@pytest.mark.parametrize("flag", ["--time-stats", "--time-stats-detailed"])
def test_cli_time_stats_match_the_jax_cli(flag, tmp_path, capsys):
    """``train --time-stats`` prints the JAX CLI's phases and call counts
    (times aside): count_pairs twice, the host seed and its placement."""
    corpus = tmp_path / "corpus.txt"
    corpus.write_bytes(TEXT)
    args = ["train", str(corpus), "--vocab", "300", "--chunk-rounds", "8", flag]
    assert j_cli.main([*args, "--out", str(tmp_path / "j.txt")]) == 0
    jax_report = capsys.readouterr().out
    assert cli.main([*args, "--out", str(tmp_path / "t.txt"), "--device", "cpu"]) == 0
    port_report = capsys.readouterr().out
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()

    def phases(report):
        return [m.groups() for line in report.splitlines() if (m := _REPORT_LINE.match(line))]

    assert phases(port_report) == phases(jax_report)
    assert ("count_pairs", "2") in phases(port_report)


def test_cli_train_dp_time_stats_match_the_jax_cli(tmp_path, capsys):
    """``train --backend dp --time-stats`` prints the JAX CLI's report
    lines (times aside): the data-parallel trainer fills no phases there."""
    corpus = tmp_path / "corpus.txt"
    corpus.write_bytes(TEXT)
    args = ["train", str(corpus), "--vocab", "300", "--backend", "dp", "--time-stats"]
    assert j_cli.main([*args, "--out", str(tmp_path / "j.txt")]) == 0
    jax_report = capsys.readouterr().out
    assert cli.main([*args, "--out", str(tmp_path / "t.txt"), "--device", "cpu"]) == 0
    port_report = capsys.readouterr().out
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()

    def lines(report):
        return [re.sub(r"\d+(\.\d+)?", "N", line) for line in report.splitlines()]

    assert lines(port_report) == lines(jax_report)
    assert "Time statistics:" in lines(port_report)
    assert not any(_REPORT_LINE.match(line) for line in port_report.splitlines())


# ---------------------------------------------------------------- train_dp

UB_CASES = {"random": RANDOM, "text": TEXT, "one_byte": b"x", "empty": b""}


@pytest.mark.parametrize("case", sorted(UB_CASES))
def test_pair_entries_match_jax(case):
    data = UB_CASES[case]
    for got, want in ((dp._byte_pair_entries(data), jdp._byte_pair_entries(data)),
                      (dp._host_pair_entries(np.frombuffer(data, np.uint8)),
                       jdp._host_pair_entries(np.frombuffer(data, np.uint8)))):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("vocab", [257, 300, 512])
def test_host_seeded_tables_equal_the_device_seed(vocab):
    """Both placements of host-counted entries equal the device seeds of
    the same corpus: fresh bytes (the sharded seed counting rows below 256),
    and a resumed stream of merged ids (every row)."""
    g = dp.DataGroup()
    ids = np.asarray(oracle.encode(TEXT, oracle.train(TEXT, vocab)), np.int32)
    for entries, tokens, max_row in (
            (dp._byte_pair_entries(TEXT), dp.shard_corpus(TEXT, g, "cpu"), 256),
            (dp._host_pair_entries(ids), dp.shard_token_ids(ids, g, "cpu"), None)):
        rep = dp._replicated_ub_from_entries(*entries, vocab_size=vocab, device="cpu")
        assert torch.equal(rep, dp.init_ub_dp(tokens, vocab, g))
        sharded = dp._sharded_ub_from_entries(*entries, vocab_size=vocab, device="cpu")
        assert sharded.shape == (vocab, vocab)
        assert torch.equal(sharded, dp.init_ub_sharded_dp(tokens, vocab, g, max_row=max_row))
        assert torch.equal(sharded.view(-1), rep)


class _Spy:
    """Counts the host seeds train_dp takes; the device seeds raise."""

    def __init__(self, monkeypatch):
        self.taken = []
        for name in ("_byte_pair_entries", "_host_pair_entries"):
            real = getattr(dp, name)
            monkeypatch.setattr(dp, name, lambda x, real=real, name=name:
                                self.taken.append(name) or real(x))

        def device_seed(*args, **kwargs):
            raise AssertionError("train_dp seeded on the device at world size 1")

        monkeypatch.setattr(dp, "init_ub_dp", device_seed)
        monkeypatch.setattr(dp, "init_ub_sharded_dp", device_seed)


@pytest.mark.parametrize("layout", ["replicated", "sharded"])
@pytest.mark.parametrize("start", ["fresh", "resumed"])
def test_train_dp_world_1_seeds_on_the_host(layout, start, monkeypatch, tmp_path):
    """At world size 1, train_dp takes the host seed (the corpus's byte
    pairs, or the resumed stream's pairs) and gives JAX train_dp's merges
    and the oracle's; the row-sharded layout runs with LAZY_VOCAB_MAX
    lowered to 257."""
    vocab, kw = 300, {}
    want = oracle.train(TEXT, vocab)
    if start == "resumed":
        ck = tmp_path / "ck"
        jdp.train_dp(TEXT, vocab, mesh=mesh_of(1), chunk_rounds=8, checkpoint_dir=str(ck),
                     checkpoint_every_chunks=2)
        kw["checkpoint_dir"] = str(ck)
    if layout == "sharded":
        monkeypatch.setattr(dp, "LAZY_VOCAB_MAX", 257)
    spy = _Spy(monkeypatch)
    stats = TimeStats()
    got = dp.train_dp(TEXT, vocab, device="cpu", stats=stats, **kw)
    assert got == want
    assert spy.taken == ["_byte_pair_entries" if start == "fresh" else "_host_pair_entries"]
    assert stats.phases["count_pairs"].calls == 1
    if start == "fresh":
        assert got == jdp.train_dp(TEXT, vocab, mesh=mesh_of(1))


def test_train_dp_world_1_time_stats_match_jax():
    ts, js = TimeStats(), JStats()
    got = dp.train_dp(TEXT, 300, device="cpu", stats=ts)
    assert got == jdp.train_dp(TEXT, 300, mesh=mesh_of(1), stats=js)
    assert _calls(ts) == _calls(js)


@pytest.mark.parametrize("world", [2, 4])
def test_train_dp_larger_groups_still_seed_on_the_device(world, tmp_path):
    """Every rank of a group of 2 or 4 sees only its slice, so it seeds on
    the device (fresh and resumed) and takes no host seed; the merges stay
    the oracle's."""
    vocab = 300
    ck = tmp_path / "ck"
    jdp.train_dp(TEXT, vocab, mesh=mesh_of(1), chunk_rounds=8, checkpoint_dir=str(ck),
                 checkpoint_every_chunks=2)
    cases = [dict(kind="seeded", data=TEXT, vocab=vocab),
             dict(kind="seeded", data=TEXT, vocab=vocab, kwargs=dict(checkpoint_dir=str(ck)))]
    want = oracle.train(TEXT, vocab)
    for rank_results in ranks.run(world, cases, timeout=150):
        for merges, taken, seeds in rank_results:
            assert merges == want and taken == [] and seeds == 1
