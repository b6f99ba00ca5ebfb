"""The port's batched encode (plain PyTorch twin of the CUDA encode kernel)
against the JAX Pallas encode kernel in interpret mode and the oracle, and
the port's copies of group_merges / schedule_merges against the originals.

Both packages take the same numpy input. All values are integers, so every
comparison is exact (tolerance 0): out arrays element for element, and
lengths.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from tests.test_encode_fuzz import _adversarial_table, _docs
from zigbpe_tpu.models import oracle
from zigbpe_tpu.native import fastio
from zigbpe_tpu.ops.pallas import encode as pe
from zigbpe_tpu_torch.models import numpy_backend
from zigbpe_tpu_torch.ops.kernels import encode as ke


def _batch(docs, L=1024) -> np.ndarray:
    buf = np.full((len(docs), L), -1, np.int32)
    for i, d in enumerate(docs):
        buf[i, : len(d)] = np.frombuffer(bytes(d), np.uint8)
    return buf


def _rows(out, lens) -> list:
    out, lens = np.asarray(out), np.asarray(lens)
    return [out[i, : lens[i]].tolist() for i in range(len(lens))]


# ------------------------------------------- the cases of test_encode_kernel.py

def _kernel_cases():
    rng = np.random.default_rng(21)  # drawn in test_encode_kernel.py's order
    data = bytes(rng.integers(97, 104, 4000, dtype=np.uint8))
    merges = oracle.train(data, 300)
    docs = [
        bytes(rng.integers(97, 104, int(rng.integers(1, 900)), dtype=np.uint8))
        for _ in range(4)
    ]
    docs += [b"", b"a", b"aaaaaaa"]
    independent = [(97, 97, 256), (256, 97, 257), (98, 99, 258)]
    return {
        "trained_table": (docs, merges),
        "independent_a": ([b"aaaab bc", b"zzz"], independent),
        "independent_b": ([b"aaaab bc", b"aaaa", b"bcbcbc"], independent),
        "row_collapsing": ([b"a" * 8], [(97, 97, 256), (256, 256, 257), (257, 257, 258)]),
        "out_of_range_ids": ([b"abcabc"], [(97, 98, 9000), (9000, 99, 257)]),
        "pad_rows_in_table": ([b"abcabc"], [(97, 98, 256), (-1, -1, -1), (256, 99, 257)]),
        "empty_table": ([b"abcabc", b""], np.zeros((0, 3), np.int32)),
    }


KERNEL_CASES = _kernel_cases()


@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_twin_matches_jax_encode_kernel(case):
    docs, merges = KERNEL_CASES[case]
    buf = _batch(docs)
    mtab = np.asarray(merges, np.int32).reshape(-1, 3)
    jout, jlens = pe.encode_rows_pallas(jnp.asarray(buf), jnp.asarray(mtab), interpret=True)
    tout, tlens = ke.encode_rows(torch.from_numpy(buf), torch.from_numpy(mtab))
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(tlens.numpy(), np.asarray(jlens))
    live = [tuple(m) for m in mtab.tolist() if m[2] >= 0]
    assert _rows(tout, tlens) == [oracle.encode(d, live) for d in docs]


def test_encode_rows_takes_a_tensor_table():
    docs, merges = KERNEL_CASES["independent_b"]
    buf = torch.from_numpy(_batch(docs))
    a = ke.encode_rows(buf, merges, cap=4)
    b = ke.encode_rows(buf, torch.tensor(merges, dtype=torch.int32), cap=4)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_twin_leaves_its_input_alone():
    buf = torch.from_numpy(_batch([b"abab", b"aaaa"]))
    before = buf.clone()
    gt, gl = ke.group_merges(np.asarray([(97, 98, 256), (97, 97, 257)], np.int32))
    ke.encode_rows_grouped(buf, torch.from_numpy(gt), torch.from_numpy(gl))
    assert torch.equal(buf, before)


def test_twin_drops_pad_holes_inside_a_row():
    # PAD anywhere in a row is dropped before the replay: the valid tokens
    # of a row are its stream
    buf = _batch([b"ab"])
    buf[0, 4:8] = np.frombuffer(b"cabc", np.uint8)  # "ab", PAD, PAD, "cabc"
    gt, gl = ke.group_merges(np.asarray([(97, 98, 256), (256, 99, 257)], np.int32))
    out, lens = ke.encode_rows_grouped(torch.from_numpy(buf), torch.from_numpy(gt),
                                       torch.from_numpy(gl))
    assert _rows(out, lens) == [[257, 257]]


# ---------------------------------------------------- the fuzz of test_encode_fuzz.py

PMAX = 32
JAX_SEEDS = [0, 1, 2, 3, 5, 6, 7, 8]  # both groupers, caps 4, 8 and 16


def _fuzz_case(seed):
    """The input of test_encode_fuzz.py's seed: rows, padded grouped table,
    the raw table, the docs, the cap and the grouper's name."""
    rng = np.random.default_rng(1000 + seed)
    table = _adversarial_table(rng, int(rng.integers(1, 25)))
    docs = _docs(rng, 3)
    cap = int(rng.choice([4, 8, 16]))
    grouper = "schedule_merges" if seed % 2 else "group_merges"
    gt, gl = getattr(pe, grouper)(np.asarray(table, np.int32), cap=cap)
    gt_p = np.full((PMAX, cap, 3), -1, np.int32)
    gt_p[: gt.shape[0]] = gt
    gl_p = np.zeros((PMAX,), np.int32)
    gl_p[: gl.shape[0]] = gl
    return _batch(docs), gt_p, gl_p, table, docs, cap, grouper


def test_jax_seeds_cover_both_groupers_and_every_cap():
    seen = {_fuzz_case(s)[5:] for s in JAX_SEEDS}
    assert seen == {(c, g) for c in (4, 8, 16) for g in ("group_merges", "schedule_merges")}


@pytest.mark.parametrize("seed", range(50))
def test_fuzz_twin_vs_oracle(seed):
    buf, gt, gl, table, docs, cap, _ = _fuzz_case(seed)
    out, lens = ke.encode_rows_grouped(torch.from_numpy(buf), torch.from_numpy(gt),
                                       torch.from_numpy(gl))
    assert _rows(out, lens) == [oracle.encode(d, table) for d in docs], (
        f"seed {seed} cap {cap}: twin diverges from the oracle for table {table}"
    )


@pytest.mark.parametrize("seed", JAX_SEEDS)
def test_fuzz_twin_matches_jax_encode_kernel(seed):
    buf, gt, gl, *_ = _fuzz_case(seed)
    jout, jlens = pe.encode_rows_grouped(jnp.asarray(buf), jnp.asarray(gt), jnp.asarray(gl),
                                         interpret=True)
    tout, tlens = ke.encode_rows_grouped(torch.from_numpy(buf), torch.from_numpy(gt),
                                         torch.from_numpy(gl))
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(tlens.numpy(), np.asarray(jlens))


# ------------------------------------------------------- copied grouping code

@pytest.mark.parametrize("seed", range(50))
@pytest.mark.parametrize("grouper", ["group_merges", "schedule_merges"])
def test_grouping_copies_match_on_fuzz_tables(seed, grouper):
    *_, table, _, cap, _ = _fuzz_case(seed)
    want = getattr(pe, grouper)(np.asarray(table, np.int32), cap=cap)
    got = getattr(ke, grouper)(np.asarray(table, np.int32), cap=cap)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def table_1k(corpus_bytes):
    table = np.asarray(fastio.train(corpus_bytes, 256 + 1024), np.int32).reshape(-1, 3)
    assert table.shape == (1024, 3)
    return table


@pytest.mark.parametrize("grouper,cap", [("group_merges", 16), ("schedule_merges", 32)])
def test_grouping_copies_match_on_a_trained_1k_table(table_1k, grouper, cap):
    want = getattr(pe, grouper)(table_1k, cap=cap)
    got = getattr(ke, grouper)(table_1k, cap=cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_twin_with_a_trained_1k_table_matches_sequential_replay(table_1k, corpus_bytes):
    gt, gl = ke.schedule_merges(table_1k, cap=32)
    docs = [corpus_bytes[i * 5000: i * 5000 + n] for i, n in enumerate([4096, 4095, 3000, 1])]
    out, lens = ke.encode_rows_grouped(torch.from_numpy(_batch(docs, 4096)),
                                       torch.from_numpy(gt), torch.from_numpy(gl))
    merges = [tuple(m) for m in table_1k.tolist()]
    assert _rows(out, lens) == [numpy_backend.encode(d, merges) for d in docs]


def test_twin_collapses_a_long_run():
    merges = [(97, 97, 256)] + [(256 + i, 256 + i, 257 + i) for i in range(12)]
    gt, gl = ke.schedule_merges(np.asarray(merges, np.int32), cap=32)
    out, lens = ke.encode_rows_grouped(torch.from_numpy(_batch([b"a" * 2000], 2048)),
                                       torch.from_numpy(gt), torch.from_numpy(gl))
    assert _rows(out, lens) == [oracle.encode(b"a" * 2000, merges)]


@pytest.mark.parametrize("L,ok", [(1024, True), (32768, True), (2048, True), (896, False),
                                  (1000, False), (65536, False), (32896, False)])
def test_encode_kernel_supported(L, ok):
    assert ke.encode_kernel_supported(L) is ok
