"""The port's serving path on the CPU: ``BasicTokenizer.encode_batch``,
``ops.encode_batch.encode_batch`` and ``pad_batch`` against the JAX
package's and the oracle, on the cases of test_encode_batch.py and a few of
the port's own (a row longer than the kernel takes, an explicit row
length). Every comparison is exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from zigbpe_tpu import BasicTokenizer as JaxTokenizer
from zigbpe_tpu.ops import encode_batch as jeb
from zigbpe_tpu_torch import BasicTokenizer
from zigbpe_tpu_torch.models import oracle
from zigbpe_tpu_torch.ops import encode_batch as teb
from zigbpe_tpu_torch.ops.kernels import encode as ke

HELLO = b"hello world hello the quick brown fox hello " * 30


@pytest.fixture(scope="module")
def trained():
    return oracle.train(HELLO, 320)


def _both(merges, docs, **kw):
    """encode_batch through the port (CPU) and the JAX package; equal."""
    got = BasicTokenizer(merges, device="cpu").encode_batch(docs, **kw)
    assert got == JaxTokenizer(merges).encode_batch(docs, **kw)
    return got


def test_encode_batch_matches_oracle(trained):
    docs = [b"hello world", b"the quick brown fox", b"", b"h", b"hello hello hello"]
    got = _both(trained, docs)
    assert got == [oracle.encode(d, trained) for d in docs]


def test_encode_batch_overlap_runs():
    merges = [(97, 97, 256), (256, 256, 257)]
    docs = [b"aaa", b"aaaa", b"aaaaa", b"aaaaaaaa"]
    assert _both(merges, docs) == [oracle.encode(d, merges) for d in docs]


def test_encode_batch_equals_single(trained):
    docs = [HELLO[i * 100: (i + 1) * 100] for i in range(10)]
    tok = BasicTokenizer(trained, device="cpu")
    assert _both(trained, docs) == [tok.encode(d, backend="device") for d in docs]


def test_encode_batch_empty():
    assert _both([(97, 98, 256)], []) == []


def test_encode_batch_no_merges():
    assert _both([], [b"ab"]) == [[97, 98]]


def test_encode_batch_str_docs(trained):
    assert _both(trained, ["hello world", "fox"]) == [
        oracle.encode(d, trained) for d in (b"hello world", b"fox")]


def test_encode_batch_row_longer_than_the_kernel_takes(trained):
    # 40,000 bytes: L = 65536, outside the kernel's rule, so the plain
    # per-merge replay runs
    docs = [HELLO * 31, b"hello"]
    assert len(docs[0]) > 32768
    assert not ke.encode_kernel_supported(65536)
    got = _both(trained[:40], docs)
    assert got == [oracle.encode(d, trained[:40]) for d in docs]


@pytest.mark.parametrize("row_length", [2048, 1000])
def test_encode_batch_explicit_row_length(trained, row_length):
    # 2048 takes the kernel's route, 1000 (not a multiple of 128) the plain one
    docs = [HELLO[:900], b"quick"]
    assert _both(trained, docs, row_length=row_length) == [
        oracle.encode(d, trained) for d in docs]


def test_encode_batch_row_length_too_short(trained):
    with pytest.raises(ValueError, match="exceeds row length"):
        BasicTokenizer(trained, device="cpu").encode_batch([b"x" * 2000], row_length=1024)


def test_encode_batch_routes_by_shape(trained, monkeypatch):
    calls = []
    real = ke.encode_rows_grouped

    def spy(tokens, gtable, glens):
        calls.append((tuple(tokens.shape), tuple(gtable.shape)))
        return real(tokens, gtable, glens)

    monkeypatch.setattr(ke, "encode_rows_grouped", spy)
    tok = BasicTokenizer(trained, device="cpu")
    tok.encode_batch([b"hello", b"fox"])        # L floored at 1024: kernel route
    tok.encode_batch([b"hello"], row_length=1000)  # plain route
    tok.encode_batch([b"hello"], row_length=2048)
    assert [c[0] for c in calls] == [(2, 1024), (1, 2048)]
    assert all(c[1][1] == 32 for c in calls)  # schedule_merges(cap=32)


@pytest.mark.parametrize("length", [None, 16, 1024])
def test_pad_batch_matches_jax(length):
    docs = [b"hello", b"", b"\x00\xff\x80" * 3, b"x"]
    jt, jl = jeb.pad_batch(docs, length)
    tt, tl = teb.pad_batch(docs, length)
    assert tt.dtype == torch.int32 and tl.dtype == torch.int32
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


def test_pad_batch_edge_cases():
    for docs in ([], [b""]):
        jt, jl = jeb.pad_batch(docs)
        tt, tl = teb.pad_batch(docs)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    with pytest.raises(ValueError, match="exceeds row length"):
        teb.pad_batch([b"abc"], 2)


@pytest.mark.parametrize("name", ["trained", "parity", "pad_rows"])
def test_encode_batch_op_matches_jax(trained, name):
    merges = {
        "trained": trained,
        "parity": [(97, 97, 256), (256, 97, 257), (256, 256, 258)],
        "pad_rows": [(104, 101, 256), (-1, -1, -1), (256, 108, 257)],
    }[name]
    docs = [HELLO[:300], b"aaaaaaa", b"", b"hel" * 20, b"a"]
    mtab = np.asarray(merges, np.int32)
    jt, _ = jeb.pad_batch(docs, 512)
    jout, jlens = jeb.encode_batch(jt, jnp.asarray(mtab))
    tt, _ = teb.pad_batch(docs, 512)
    tout, tlens = teb.encode_batch(tt, torch.from_numpy(mtab))
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(tlens.numpy(), np.asarray(jlens))
    live = [m for m in merges if m[2] >= 0]
    assert [tout[i, : tlens[i]].tolist() for i in range(len(docs))] == [
        oracle.encode(d, live) for d in docs]


def test_encode_batch_op_takes_a_list_table():
    tt, _ = teb.pad_batch([b"abab"], 8)
    out, lens = teb.encode_batch(tt, [(97, 98, 256)])
    assert out[0, : lens[0]].tolist() == [256, 256]
