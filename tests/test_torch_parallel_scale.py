"""Scale features of the port's data-parallel trainer, mirroring
tests/test_parallel_scale.py: the row-sharded table (``LAZY_VOCAB_MAX``
lowered to 257 so every sharded path runs cheaply), vocab past 8192, the
shrink schedule, and checkpoint interchange with the JAX data-parallel
trainer and both packages' single-chip trainers, in both directions. Ranks
are processes of a gloo group on the CPU (tests/torch_dp_ranks.py)."""

import numpy as np
import pytest

from tests import torch_dp_ranks as ranks
from zigbpe_tpu import train as j_train
from zigbpe_tpu.models import oracle
from zigbpe_tpu.parallel import train_dp as jdp
from zigbpe_tpu.utils import checkpoint as ckpt
from zigbpe_tpu_torch import train as t_train
from zigbpe_tpu_torch.parallel import train_dp as dp

SHARDED_TEXT = (b"the quick brown fox jumps over the lazy dog " * 50, 300)
SHARDED_RANDOM = (bytes(np.random.default_rng(11).integers(97, 103, 1500, dtype=np.uint8)), 290)
WALL = (b"a" * 200 + b"b" * 100, 9000)
SHRINK = b"hello world hello " * 300
FOX = b"the quick brown fox jumps over the lazy dog " * 40
REPLAY = (bytes(np.random.default_rng(12).integers(97, 101, 1200, dtype=np.uint8)), 280)
UB = (bytes(np.random.default_rng(13).integers(0, 256, 3000, dtype=np.uint8)), 264)


def _train(data, vocab, **kw):
    return dict(kind="train", data=data, vocab=vocab, **kw)


def mesh_of(n):
    import jax

    return jdp.data_mesh(np.asarray(jax.devices()[:n]))


def _mid_checkpoint(d, data: bytes, vocab: int, at: int):
    """A mid-training checkpoint (after ``at`` merges) from the oracle."""
    full = oracle.train(data, vocab)
    ckpt.save(d, full[:at], np.asarray(oracle.encode(data, full[:at]), np.int32), vocab,
              np.zeros(at, np.int32))
    return full


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """Checkpoint directories; the JAX data-parallel trainer's (4 devices) mid-run
    checkpoint (after 16 merges: written at its second chunk of 8, copied
    when its third starts) is made here, before the ranks start."""
    root = tmp_path_factory.mktemp("dp_scale")
    jax_run = root / "jax_run"
    jdp.train_dp(FOX, 300, mesh=mesh_of(4), chunk_rounds=8, checkpoint_dir=str(jax_run),
                 checkpoint_every_chunks=2,
                 stats=ranks._SnapshotStats(jax_run, root / "jax_mid", 3, 0))
    _mid_checkpoint(root / "oracle_mid", FOX, 300, at=20)
    return root


@pytest.fixture(scope="module")
def ranks8():
    cases = {
        "sharded_text": _train(*SHARDED_TEXT, lazy_vocab_max=257),
        "sharded_random": _train(*SHARDED_RANDOM, lazy_vocab_max=257),
        "init_ub_sharded": dict(kind="init_ub", data=UB[0], vocab=UB[1], max_row=256),
    }
    results = ranks.run(8, list(cases.values()), timeout=150)
    return {name: [r[i] for r in results] for i, name in enumerate(cases)}


@pytest.fixture(scope="module")
def ranks4(dirs):
    import shutil

    lazy = dict(lazy_vocab_max=257)
    cases = {
        "sharded_random": _train(*SHARDED_RANDOM, **lazy),
        "wall": _train(*WALL),
        "shrink": _train(SHRINK, 300, kwargs=dict(shrink=True, chunk_rounds=8)),
        "no_shrink": _train(SHRINK, 300, kwargs=dict(shrink=False, chunk_rounds=8)),
        "resume_oracle": _train(FOX, 300, kwargs=dict(checkpoint_dir=str(dirs / "oracle_mid"))),
        "resume_jax": _train(FOX, 300, kwargs=dict(checkpoint_dir=str(dirs / "jax_mid"))),
        "resume_jax_sharded": _train(FOX, 300, **lazy, kwargs=dict(
            checkpoint_dir=str(dirs / "jax_mid_copy"))),
        "every_chunk": _train(FOX, 300, kwargs=dict(
            chunk_rounds=8, checkpoint_dir=str(dirs / "port_final"), checkpoint_every_chunks=1)),
        "port_mid": _train(FOX, 300, snapshot=(str(dirs / "port_run"), str(dirs / "port_mid"), 3),
                           kwargs=dict(chunk_rounds=8, checkpoint_dir=str(dirs / "port_run"),
                                       checkpoint_every_chunks=2)),
        "replay": _train(*REPLAY, kwargs=dict(chunk_rounds=4, checkpoint_dir=str(dirs / "replay"),
                                              checkpoint_every_chunks=2)),
    }
    shutil.copytree(dirs / "jax_mid", dirs / "jax_mid_copy")
    results = ranks.run(4, list(cases.values()), timeout=150)
    return {name: [r[i] for r in results] for i, name in enumerate(cases)}


def _same_on_every_rank(per_rank):
    assert all(r == per_rank[0] for r in per_rank), "ranks disagree"
    return per_rank[0]


def test_sharded_ub_matches_oracle(ranks8):
    data, vocab = SHARDED_TEXT
    assert _same_on_every_rank(ranks8["sharded_text"]) == oracle.train(data, vocab)


def test_sharded_ub_matches_jax_dp(ranks4, monkeypatch):
    data, vocab = SHARDED_RANDOM
    monkeypatch.setattr(jdp, "LAZY_VOCAB_MAX", 257)
    got = _same_on_every_rank(ranks4["sharded_random"])
    assert got == jdp.train_dp(data, vocab, mesh=mesh_of(4))


@pytest.mark.parametrize("world", [1, 4, 8])
def test_sharded_ub_world_size_invariance(world, request, monkeypatch):
    data, vocab = SHARDED_RANDOM
    if world == 1:
        monkeypatch.setattr(dp, "LAZY_VOCAB_MAX", 257)
        got = dp.train_dp(data, vocab, device="cpu")
    elif world == 4:
        got = _same_on_every_rank(request.getfixturevalue("ranks4")["sharded_random"])
    else:
        got = _same_on_every_rank(request.getfixturevalue("ranks8")["sharded_random"])
    assert got == oracle.train(data, vocab)


def test_vocab_above_8192_wall(ranks4):
    data, vocab = WALL
    assert _same_on_every_rank(ranks4["wall"]) == oracle.train(data, vocab)


def test_shrink_invariance(ranks4):
    a = _same_on_every_rank(ranks4["shrink"])
    assert a == _same_on_every_rank(ranks4["no_shrink"]) == oracle.train(SHRINK, 300)


@pytest.mark.parametrize("name", ["resume_oracle", "resume_jax", "resume_jax_sharded"])
def test_dp_resumes_single_chip_and_jax_dp_checkpoints(ranks4, name):
    assert _same_on_every_rank(ranks4[name]) == oracle.train(FOX, 300)


def test_jax_dp_checkpoint_was_mid_run(dirs):
    merges, _, _, _ = ckpt.load(dirs / "jax_mid")
    assert len(merges) == 16


def test_single_chip_resumes_dp_checkpoint(ranks4, dirs):
    full = oracle.train(FOX, 300)
    assert _same_on_every_rank(ranks4["every_chunk"]) == full
    merges, ids, vocab, _ = ckpt.load(dirs / "port_final")
    assert vocab == 300 and merges == full
    assert ids.tolist() == oracle.encode(FOX, merges)
    assert j_train.train(FOX, 300, checkpoint_dir=str(dirs / "port_final")) == full
    assert t_train.train(FOX, 300, checkpoint_dir=str(dirs / "port_final"), device="cpu") == full


@pytest.mark.parametrize("resume_on", ["jax_dp", "jax_single", "port_single"])
def test_mid_run_dp_checkpoint_resumes_elsewhere(ranks4, dirs, tmp_path, resume_on):
    import shutil

    full = oracle.train(FOX, 300)
    assert _same_on_every_rank(ranks4["port_mid"]) == full
    d = tmp_path / "ck"
    shutil.copytree(dirs / "port_mid", d)
    merges, ids, _, _ = ckpt.load(d)
    assert len(merges) == 16 and ids.tolist() == oracle.encode(FOX, merges)
    if resume_on == "jax_dp":
        got = jdp.train_dp(FOX, 300, mesh=mesh_of(4), checkpoint_dir=str(d))
    elif resume_on == "jax_single":
        got = j_train.train(FOX, 300, checkpoint_dir=str(d))
    else:
        got = t_train.train(FOX, 300, checkpoint_dir=str(d), device="cpu")
    assert got == full


def test_dp_checkpoint_stream_matches_replay(ranks4, dirs):
    _same_on_every_rank(ranks4["replay"])
    merges, ids, _, _ = ckpt.load(dirs / "replay")
    assert ids.tolist() == oracle.encode(REPLAY[0], merges)


def test_sharded_ub_init_matches_jax_and_dense(ranks8):
    data, V = UB
    D = 8
    Vp = -(-V // D) * D
    want = np.asarray(jdp._init_ub_sharded_jit(jdp.shard_corpus(data, mesh_of(D)), vocab_size=V,
                                               rows_per_shard=Vp // D, max_row=256,
                                               mesh=mesh_of(D)))
    got = np.concatenate(ranks8["init_ub_sharded"])
    assert np.array_equal(got, want)
    ids = np.frombuffer(data, np.uint8).astype(np.int64)
    dense = np.zeros((Vp, V), np.int32)
    np.add.at(dense, (ids[:-1], ids[1:]), 1)
    assert np.array_equal(got, dense)


def test_sharded_ub_deep_vocab_matches_oracle(monkeypatch, corpus_bytes):
    # a deep vocab on a small corpus: the last rounds merge pairs seen two
    # or three times, where most bounds of the table tie
    monkeypatch.setattr(dp, "LAZY_VOCAB_MAX", 257)
    data = corpus_bytes[:1024]
    want = oracle.train(data, 600)
    assert len(want) == 344 and want[-1] == (598, 310, 599)
    assert dp.train_dp(data, 600, device="cpu") == want
