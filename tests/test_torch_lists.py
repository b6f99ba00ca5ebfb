"""The serving path's list builder (``zigbpe_tpu_torch.native.lists``)
against its plain twin, one ``tolist`` a row: equal lists at the table sizes
of the tiny, 1K and GPT-2 vocabularies, ids outside the table made anew and
counted, no reference left behind, the library rebuilt or absent, and
``encode_batch`` on the card. This file imports neither jax nor the JAX
package, so that on the card's machine it runs alone:
``python -m pytest tests/test_torch_lists.py --noconftest -q``."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

from zigbpe_tpu_torch.models import oracle
from zigbpe_tpu_torch.models.basic_tokenizer import BasicTokenizer
from zigbpe_tpu_torch.native import lists
from zigbpe_tpu_torch.utils import serde

REPO = Path(__file__).resolve().parents[1]
TEXT = (REPO / "tests" / "data" / "taylorswift.txt").read_bytes()
PAD = -1


def _batch(B: int, L: int, T: int, lengths, seed: int):
    """Rows of ids in [0, T) up to each length and PAD after it, as the
    encode routes leave them."""
    g = torch.Generator().manual_seed(seed)
    rows = torch.randint(0, T, (B, L), generator=g, dtype=torch.int32)
    lens = torch.as_tensor(lengths, dtype=torch.int32)
    rows[torch.arange(L) >= lens[:, None]] = PAD
    return rows, lens


def _mixed(B: int, L: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    lens = torch.randint(0, L + 1, (B,), generator=g, dtype=torch.int32)
    lens[:3] = torch.tensor([0, L, 1])
    return lens


SHAPES = {
    "empty_rows": (4, 16, lambda B, L: [0] * B),
    "one_row": (1, 300, lambda B, L: [217]),
    "1024_mixed": (1024, 64, lambda B, L: _mixed(B, L, 1)),
    "no_rows": (0, 8, lambda B, L: []),
}


@pytest.mark.parametrize("T", [256, 1280, 50256])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_the_builder_equals_the_plain_twin(shape, T):
    B, L, lengths = SHAPES[shape]
    rows, lens = _batch(B, L, T, lengths(B, L), seed=T)
    got, shared, made = lists.row_lists(rows, lens, T)
    want = lists.plain_lists(rows, lens)
    assert got == want
    assert all(type(x) is int for row in got for x in row)
    assert (shared, made) == (int(lens.sum()), 0)


@pytest.mark.parametrize("view", ["column_slice", "strided"])
def test_rows_that_are_views_of_a_wider_batch(view):
    """Rows narrower than their stride are read in place; rows whose ids
    are not adjacent are made contiguous first."""
    wide, _ = _batch(64, 96, 1280, [96] * 64, seed=3)
    rows = wide[:, :40] if view == "column_slice" else wide[:, ::2]
    lens = _mixed(64, rows.shape[1], 4)
    got, shared, made = lists.row_lists(rows, lens, 1280)
    assert got == lists.plain_lists(rows, lens)
    assert (shared, made) == (int(lens.sum()), 0)


def test_ids_outside_the_table_come_back_exactly_and_are_made():
    """Outside [0, T) means outside the size asked for, even where the
    shared table is longer."""
    T = 300
    assert len(lists.table(1000)) >= 1000
    row = [-1, -7, 0, 255, 299, 300, 301, 50255, 2**31 - 1, -2**31]
    rows = torch.tensor([row, row[::-1]], dtype=torch.int32)
    lens = torch.tensor([len(row), 6], dtype=torch.int32)
    got, shared, made = lists.row_lists(rows, lens, T)
    assert got == [row, row[::-1][:6]] == lists.plain_lists(rows, lens)
    outside = sum(not 0 <= x < T for r in got for x in r)
    assert (shared, made) == (16 - outside, outside) and outside == 12


def test_a_batch_built_and_dropped_leaves_no_reference():
    T = 1280
    table = lists.table(T)
    sample = [table[i] for i in (0, 1, 255, 256, 257, 640, 1279)]

    def refs():
        return [sys.getrefcount(x) for x in sample]

    start = refs()
    rows, lens = _batch(256, 128, T, _mixed(256, 128, 5), seed=6)
    rows[0, :4] = torch.tensor([1279, 5000, -3, 257], dtype=torch.int32)
    lens[0] = 4
    got, shared, made = lists.row_lists(rows, lens, T)
    twin = lists.plain_lists(rows, lens)
    assert made == 2 and got == twin
    assert sys.getrefcount(got) == sys.getrefcount(twin)
    assert sys.getrefcount(got[0]) == sys.getrefcount(twin[0])
    assert refs()[5] > start[5]
    del got
    del twin
    assert refs() == start


def test_the_table_grows_to_the_largest_size_and_holds_its_ints():
    small = lists.table(300)
    assert len(small) >= 300 and small[:300] == list(range(300))
    big = lists.table(len(small) + 1000)
    assert big == list(range(len(big))) and lists.table(10) is big
    assert small[:300] == list(range(300))  # a list handed out is not changed


def test_threads_asking_for_tables_of_different_sizes_get_exact_lists():
    """Threads that grow the shared table at once each get a table that
    holds their ids: every result equals the twin."""
    from concurrent.futures import ThreadPoolExecutor

    sizes = [300, 50256, 1280, 70000] * 4
    batches = [_batch(16, 64, T, _mixed(16, 64, k), seed=k) for k, T in enumerate(sizes)]

    def one(k):
        rows, lens = batches[k]
        got, shared, made = lists.row_lists(rows, lens, sizes[k])
        return got == lists.plain_lists(rows, lens) and made == 0 and shared == int(lens.sum())

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(16) as pool:
            done = list(pool.map(one, range(len(sizes)), timeout=120))
    finally:
        sys.setswitchinterval(interval)
    assert done == [True] * len(sizes)


def test_bad_rows_raise_before_anything_is_read():
    rows = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        lists.row_lists(rows.long(), torch.tensor([1, 1]), 300)
    with pytest.raises(ValueError, match="lengths"):
        lists.row_lists(rows, torch.tensor([1, 1, 1]), 300)
    with pytest.raises(ValueError, match="length 9 of row 1"):
        lists.row_lists(rows, torch.tensor([8, 9]), 300)
    with pytest.raises(ValueError, match="length -1 of row 0"):
        lists.row_lists(rows, torch.tensor([-1, 0]), 300)


def test_the_library_builds_here_and_a_stale_file_is_built_again(monkeypatch, tmp_path):
    assert lists.available() and lists.build()
    monkeypatch.setattr(lists, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(lists, "_lib", None)
    monkeypatch.setattr(lists, "_tried", False)
    lists.library_path().write_bytes(b"not a shared library")
    rows, lens = _batch(3, 10, 400, [10, 2, 0], seed=7)
    assert lists.row_lists(rows, lens, 400)[0] == lists.plain_lists(rows, lens)
    assert lists.library_path().read_bytes()[:4] == b"\x7fELF"


def _no_library(monkeypatch):
    monkeypatch.setattr(lists, "_compile", lambda force: None)
    monkeypatch.setattr(lists, "_lib", None)
    monkeypatch.setattr(lists, "_tried", False)


@pytest.mark.parametrize("route", ["kernel", "plain"])
def test_without_the_library_encode_batch_gives_the_same_lists_all_made(monkeypatch, route):
    merges = oracle.train(TEXT[:4000], 300)
    docs = [TEXT[:700], TEXT[900:1000], b"", TEXT[2000:2600]]
    kw = {} if route == "kernel" else {"row_length": 768}  # under the kernel's rows
    tok = BasicTokenizer(merges, device="cpu")
    want = tok.encode_batch(docs, **kw)
    _no_library(monkeypatch)
    assert not lists.available() and not lists.build()
    bare = BasicTokenizer(merges, device="cpu")
    assert bare.encode_batch(docs, **kw) == want == [oracle.encode(d, merges) for d in docs]
    n = sum(map(len, want))
    assert tok.time_stats.counters["encode_ids.shared"] == n
    assert bare.time_stats.counters["encode_ids.shared"] == 0
    assert bare.time_stats.counters["encode_ids.made"] == n
    assert tok.time_stats.counters["encode_ids.made"] == 0


def test_encode_batch_on_the_card_equals_the_plain_twin(monkeypatch):
    """1024 rows of 32,768 bytes through the encode kernel: the lists equal
    one ``tolist`` a row of the same copied rows, and no id is made anew."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    merges = serde.load(REPO / "benchmark" / "data" / "bpe_1k.merges.txt")
    row = 32768
    tiled = TEXT * (1024 * row // len(TEXT) + 1)
    docs = [tiled[i * row:(i + 1) * row] for i in range(1024)]
    seen = []
    built = lists.row_lists

    def spy(rows, lengths, size):
        seen.append((rows, lengths))
        return built(rows, lengths, size)

    monkeypatch.setattr(lists, "row_lists", spy)
    tok = BasicTokenizer(merges, device="cuda")
    got = tok.encode_batch(docs)
    (rows, lengths), = seen
    assert rows.shape == (1024, row) and not rows.is_cuda
    assert got == lists.plain_lists(rows, lengths)
    counters = tok.time_stats.counters
    assert counters["encode_rows.kernel"] == 1024
    assert counters["encode_ids.made"] == 0
    assert counters["encode_ids.shared"] == sum(map(len, got)) == int(lengths.sum())
