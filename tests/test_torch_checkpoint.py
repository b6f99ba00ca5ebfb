"""Checkpoint / resume in the port: the cases of test_checkpoint.py on the
port's trainer, checkpoints carried between the two packages both ways,
and the port's copy of ``utils/checkpoint.py`` against its original. A
resumed run must give exactly the oracle's merges."""

import numpy as np
import pytest

from zigbpe_tpu import train as j_train
from zigbpe_tpu.models import oracle
from zigbpe_tpu.utils import checkpoint as j_checkpoint
from zigbpe_tpu_torch import train as t_train
from zigbpe_tpu_torch.utils import checkpoint

DATA = b"the quick brown fox jumps over the lazy dog hello world " * 80


def _crash(ck, data, want, keep, vocab):
    """Rewind the checkpoint at ``ck`` to ``keep`` merges, as a run that
    died after that many would have left it (test_checkpoint.py's way)."""
    merges, _, _, occ = checkpoint.load(ck)
    checkpoint.save(ck, merges[:keep], np.asarray(
        oracle.encode(data, want[:keep]), dtype=np.int32), vocab, occ[:keep])


def test_save_load_round_trip(tmp_path):
    merges = oracle.train(DATA, 280)
    toks = np.asarray(oracle.encode(DATA, merges), dtype=np.int32)
    checkpoint.save(tmp_path / "ck", merges, toks, 300)
    m2, t2, vs, occ = checkpoint.load(tmp_path / "ck")
    assert m2 == merges
    assert (t2 == toks).all()
    assert vs == 300


def test_resume_produces_identical_merges(tmp_path):
    ck = tmp_path / "ck"
    want = oracle.train(DATA, 300)
    got_partial = t_train.train(DATA, 300, chunk_rounds=10, checkpoint_dir=str(ck),
                                checkpoint_every_chunks=1, device="cpu")
    assert got_partial == want
    assert checkpoint.exists(ck)
    _crash(ck, DATA, want, 20, 300)
    got = t_train.train(DATA, 300, chunk_rounds=10, checkpoint_dir=str(ck),
                        checkpoint_every_chunks=1, device="cpu")
    assert got == want


def test_resume_vocab_mismatch(tmp_path):
    ck = tmp_path / "ck"
    t_train.train(DATA, 280, chunk_rounds=8, checkpoint_dir=str(ck),
                  checkpoint_every_chunks=1, device="cpu")
    with pytest.raises(ValueError, match="vocab_size"):
        t_train.train(DATA, 300, checkpoint_dir=str(ck), device="cpu")


def test_corrupt_checkpoint(tmp_path):
    ck = tmp_path / "ck"
    merges = oracle.train(DATA, 270)
    checkpoint.save(ck, merges, np.arange(10, dtype=np.int32), 270)
    (ck / "meta.json").write_text('{"format": "something-else"}')
    with pytest.raises(ValueError, match="not a zigbpe-tpu checkpoint"):
        checkpoint.load(ck)
    checkpoint.save(ck, merges, np.arange(10, dtype=np.int32), 270)
    meta = (ck / "meta.json").read_text().replace('"num_tokens": 10', '"num_tokens": 11')
    (ck / "meta.json").write_text(meta)
    with pytest.raises(ValueError, match="corrupt checkpoint"):
        t_train.train(DATA, 270, checkpoint_dir=str(ck), device="cpu")


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("vocab,keep", [(300, 20), (9000, 40)], ids=["lazy", "sorted"])
def test_checkpoint_resumes_across_packages(tmp_path, writer, vocab, keep):
    """A checkpoint the JAX trainer wrote resumes on the port, and one the
    port wrote resumes on the JAX trainer, both to the oracle's merges."""
    ck = str(tmp_path / "ck")
    data = DATA[:600] if vocab > t_train.LAZY_VOCAB_MAX else DATA
    want = oracle.train(data, vocab)
    assert len(want) > keep
    kw = {"chunk_rounds": 10, "checkpoint_dir": ck, "checkpoint_every_chunks": 1}
    first, second = ((j_train.train, {}), (t_train.train, {"device": "cpu"}))
    if writer == "port":
        first, second = second, first
    fn, extra = first
    assert fn(data, vocab, **kw, **extra) == want
    _crash(ck, data, want, keep, vocab)
    fn, extra = second
    assert fn(data, vocab, **kw, **extra) == want


def test_checkpoint_copy_matches(tmp_path):
    """The port's copy writes the same three files as the original, byte for
    byte, and each loads the other's."""
    merges = oracle.train(DATA, 290)
    toks = np.asarray(oracle.encode(DATA, merges), dtype=np.int32)
    occ = np.arange(len(merges), dtype=np.int32)
    checkpoint.save(tmp_path / "t", merges, toks, 300, occ)
    j_checkpoint.save(tmp_path / "j", merges, toks, 300, occ)
    for name in ("state.npz", "merges.txt", "meta.json"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    for load, path in ((checkpoint.load, "j"), (j_checkpoint.load, "t")):
        m2, t2, vs, o2 = load(tmp_path / path)
        assert m2 == merges and vs == 300
        np.testing.assert_array_equal(t2, toks)
        np.testing.assert_array_equal(o2, occ)
    assert checkpoint.exists(tmp_path / "j") and not checkpoint.exists(tmp_path / "none")
