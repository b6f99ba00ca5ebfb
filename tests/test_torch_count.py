"""The verify pass's count (``ops/kernels/count.py``, ``csrc/count.cu``) on
the CPU: the twin against the chunked count it was taken from and against
``count_pair`` on row-local streams, the kernel's plan replayed in numpy
(its hash table, its steps, its tail and its fold), the wrapper's guards,
and the ``verify_queries`` counter.

On the card: ``python -m pytest benchmark/tests/test_count_card.py -m card``.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from zigbpe_tpu_torch.ops import core
from zigbpe_tpu_torch.ops.kernels import LAYOUT, _build
from zigbpe_tpu_torch.ops.kernels import count as kcount
from zigbpe_tpu_torch.utils.profiling import TimeStats

CSRC = Path(__file__).resolve().parents[1] / "zigbpe_tpu_torch" / "csrc"
V = 1280  # the benchmark's vocab


def chunked_count(stream: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """``core.count_queries`` as it was before the kernel: the stream
    compared with every query in chunks of 2^20 slots."""
    out = torch.zeros(queries.shape[0], dtype=torch.int64)
    queries = queries.to(stream.dtype)
    for chunk in stream.split(1 << 20):
        out += (chunk[None, :] == queries[:, None]).sum(1)
    return out.to(torch.int32)


def row_local(seed: int, rows: int, live: int, vocab: int = V) -> torch.Tensor:
    """A stream in the merge kernel's row-local layout: ``live`` rows, each
    a prefix of 2-128 tokens (a skewed draw, so a few pairs are common)
    and a PAD tail, then ``rows - live`` rows of PAD."""
    r = np.random.default_rng(seed)
    t = np.full((rows, LAYOUT), -1, np.int32)
    for i in range(live):
        n = int(r.integers(2, LAYOUT + 1))
        t[i, :n] = np.minimum(r.zipf(1.6, n) - 1, vocab - 1)
    return torch.from_numpy(t.reshape(-1))


def pid_stream(tokens: torch.Tensor, vocab: int = V) -> torch.Tensor:
    """The packed pair-id stream ``core.stream_count_fn`` counts."""
    a, b = core.pair_streams(tokens, LAYOUT)
    return torch.where(b >= 0, a * vocab + b, -1)


def queries_of(pids: torch.Tensor, nq: int, seed: int) -> torch.Tensor:
    """``nq`` int64 queries: pairs the stream holds (the commonest first),
    a pair it never holds, and repeats."""
    r = np.random.default_rng(seed)
    held, counts = torch.unique(pids[pids >= 0], return_counts=True)
    held = held[counts.argsort(descending=True)].tolist()
    seen = set(held)
    absent = next(p for p in range(V * V) if p not in seen)
    pool = held[: max(1, nq // 2)] + [absent]
    return torch.tensor(r.choice(pool, nq).tolist(), dtype=torch.int64)


# ------------------------------------------------------------------ twin

@pytest.mark.parametrize("nq", [1, 105, 4096])
def test_twin_equals_the_chunked_count_and_count_pair(nq):
    tokens = row_local(nq, 24, 20)
    pids = pid_stream(tokens)
    q = queries_of(pids, nq, nq)
    got = kcount.count_queries(pids, q)
    assert got.dtype == torch.int32 and torch.equal(got, chunked_count(pids, q))
    assert torch.equal(core.count_queries(pids, q), got)
    first, second = (q // V).tolist(), (q % V).tolist()
    want = [int(core.count_pair(tokens, a, b, LAYOUT)) for a, b in zip(first[:64], second[:64])]
    assert got[:64].tolist() == want
    # the trainer's pass: pair components in, the same counts out
    fn = core.packed_count_fn(tokens, V, LAYOUT)
    assert torch.equal(fn(q // V, q % V), got)


def test_duplicates_get_equal_counts_and_an_absent_pair_counts_zero():
    pids = pid_stream(row_local(7, 8, 6))
    held = int(pids[pids >= 0][0])
    absent = V * V - 1
    assert not bool((pids == absent).any())
    q = torch.tensor([held, absent, held, held, absent], dtype=torch.int64)
    got = kcount.count_queries(pids, q).tolist()
    assert got[0] == got[2] == got[3] == int((pids == held).sum()) > 0
    assert got[1] == got[4] == 0


@pytest.mark.parametrize("n", [1, 2, 3, 5, 4097, (1 << 20) + 5])
def test_every_length_and_every_pad_slot(n):
    """Lengths below one vector, not a multiple of 4, across two 2^20
    chunks; PAD slots inside and a PAD tail, which no query matches."""
    r = np.random.default_rng(n)
    s = r.integers(0, 6, n).astype(np.int32)
    s[r.random(n) < 0.3] = -1
    if n > 3:
        s[-3:] = -1  # a PAD tail
    pids = torch.from_numpy(s)
    q = torch.tensor([0, 5, 3, 0, 6], dtype=torch.int32)
    got = kcount.count_queries(pids, q)
    want = [int((pids == v).sum()) for v in q.tolist()]
    assert got.tolist() == want and torch.equal(got, chunked_count(pids, q))


def test_an_all_pad_stream_and_no_queries():
    pids = torch.full((4096,), -1, dtype=torch.int32)
    assert kcount.count_queries(pids, torch.arange(105)).tolist() == [0] * 105
    assert kcount.count_queries(pids, torch.zeros(0, dtype=torch.int64)).shape == (0,)


def test_a_negative_or_wrapping_query_counts_as_its_int32_value():
    pids = torch.tensor([-1, -1, 7, 7, 2**31 - 1], dtype=torch.int32)
    q = torch.tensor([-1, 7, 2**32 + 7, 2**31 - 1], dtype=torch.int64)
    assert kcount.count_queries(pids, q).tolist() == [0, 2, 2, 1]


@pytest.mark.parametrize("stream,queries,match", [
    (torch.zeros(8, dtype=torch.int64), torch.zeros(2, dtype=torch.int64), "int32"),
    (torch.zeros((2, 4), dtype=torch.int32), torch.zeros(2, dtype=torch.int64), "1-d int32"),
    (torch.zeros(8, dtype=torch.int32), torch.zeros(2), "int32 or int64"),
    (torch.zeros(8, dtype=torch.int32), torch.zeros((2, 1), dtype=torch.int64), "1-d"),
    (torch.zeros(8, dtype=torch.int32), torch.zeros(kcount.MAX_QUERIES + 1, dtype=torch.int64),
     "at most 8192"),
    (torch.zeros(8, dtype=torch.int32), torch.zeros(2, dtype=torch.int64, device="meta"),
     "queries on meta"),
])
def test_bad_arguments_raise(stream, queries, match):
    with pytest.raises(ValueError, match=match):
        kcount.count_queries(stream, queries)


def test_the_limit_itself_is_taken():
    pids = torch.arange(-1, 15, dtype=torch.int32)
    q = torch.arange(kcount.MAX_QUERIES)
    assert kcount.count_queries(pids, q).tolist() == [1] * 15 + [0] * (kcount.MAX_QUERIES - 15)


def test_a_cpu_tensor_never_builds_or_launches(monkeypatch):
    def refuse(*args):
        raise AssertionError("built or launched on the CPU")

    monkeypatch.setattr(_build, "build", refuse)
    monkeypatch.setattr(_build, "library", refuse)
    monkeypatch.setattr(kcount._COUNT, "fn", refuse)
    before = kcount.count_queries.launches
    pids = pid_stream(row_local(3, 16, 12))
    kcount.count_queries(pids, torch.arange(105))
    core.packed_count_fn(pids.new_full((256,), -1), V, LAYOUT)(torch.arange(3), torch.arange(3))
    assert kcount.count_queries.launches == before


def test_a_cuda_launch_is_the_wrappers_one_launch(monkeypatch):
    """With the entry stubbed and a CPU tensor taken for a card's, the
    wrapper passes the stream, its length, the int64 queries as they are
    (int32 ones widened), their number and the output, and counts one
    launch a call."""
    calls = []
    monkeypatch.setattr(_build, "on_card", lambda x, name: True)
    monkeypatch.setattr(kcount, "_COUNT", lambda *args: calls.append(args))
    pids = torch.zeros(4097, dtype=torch.int32)
    q = torch.arange(105)
    before = kcount.count_queries.launches
    out = kcount.count_queries(pids, q)
    assert kcount.count_queries.launches == before + 1 and out.shape == (105,)
    (index, sp, n, qp, nq, op), = calls
    assert (sp, n, qp, nq, op) == (pids.data_ptr(), 4097, q.data_ptr(), 105, out.data_ptr())
    kcount.count_queries(pids, q.int())
    assert calls[-1][3] != q.data_ptr() and calls[-1][4] == 105
    with pytest.raises(ValueError, match="16-byte aligned"):
        kcount.count_queries(pids[1:], q)
    with pytest.raises(ValueError, match="contiguous"):
        kcount.count_queries(pids, torch.arange(210)[::2])
    assert kcount.count_queries.launches == before + 2


# ------------------------------------------------------------------ plan

def _constants() -> dict:
    src = (CSRC / "count.cu").read_text()
    cu = {m[0]: int(m[1]) for m in re.findall(r"constexpr int (\w+) = (-?\d+);", src)}
    cu["HASH"] = int(re.search(r"constexpr unsigned HASH = (\d+)u;", src)[1])
    return cu


def test_constants_match_the_kernel_source():
    cu = _constants()
    for name in ("THREADS", "VECS", "BLOCKS_PER_SM", "MAX_QUERIES", "MIN_BITS", "LOAD_BITS",
                 "MAX_BITS", "COPIES", "COUNT_BYTES", "HASH"):
        assert cu[name] == getattr(kcount, name), name
    assert cu["EMPTY"] == -1
    # the opt-in to dynamic shared memory belongs to the function, not to a
    # launch: made once, for the most any plan takes, so a smaller plan
    # asked for first never caps a larger one
    src = (CSRC / "count.cu").read_text()
    assert re.search(r"cudaFuncAttributeMaxDynamicSharedMemorySize,\s*"
                     r"\(1 << MAX_BITS\) \* \(int\)sizeof\(int2\) \+ COUNT_BYTES", src)
    most = max(kcount.count_plan(8, nq, 132, 1).smem for nq in range(1, kcount.MAX_QUERIES + 1))
    assert most <= (1 << kcount.MAX_BITS) * 8 + kcount.COUNT_BYTES <= 232448


def find_index(keys: np.ndarray, index: np.ndarray, t: np.ndarray, bits: int) -> np.ndarray:
    """The kernel's ``find`` on every token at once: the dense index of its
    key, or -1 (PAD, or no key). Also asserts every probe sequence ends."""
    mask = (1 << bits) - 1
    out = np.full(t.shape, -1, np.int64)
    pos = (t.astype(np.uint64) * kcount.HASH % 2**32 >> (32 - bits)).astype(np.int64)
    open_ = t >= 0
    for _ in range(1 << bits):
        if not open_.any():
            return out
        k = keys[pos]
        hit = open_ & (k == t)
        out[hit] = index[pos[hit]]
        open_ &= ~hit & (k != -1)
        pos = (pos + 1) & mask
    raise AssertionError("a probe sequence never ended")


def replay_count(stream: np.ndarray, queries: np.ndarray, sms: int, occupancy: int):
    """What count_queries_kernel does under ``count_plan``, block by block:
    each block's table (queries inserted by linear probing from their home
    entries, each new key taking the next dense index), its steps (THREADS *
    VECS vectors, block b taking b, b + grid, ...), block 0's tail, each
    token counted in its lane's copy of its key's row, and the fold of the
    copies of every block into the output. Returns the plan, the counts and
    how often each slot was read."""
    n, nq = stream.shape[0], queries.shape[0]
    plan = kcount.count_plan(n, nq, sms, occupancy)
    size, mask = 1 << plan.bits, (1 << plan.bits) - 1
    rows = 1 << plan.qbits
    assert rows >= nq and plan.copies & (plan.copies - 1) == 0
    assert plan.copies * rows * 4 <= kcount.COUNT_BYTES or plan.copies == 1
    assert plan.smem == size * 8 + plan.copies * rows * 4 <= 232448
    keys = np.full(size, -1, np.int64)
    index = np.full(size, -1, np.int64)
    distinct = 0
    q = queries.astype(np.int64)
    q = np.where(q >= 2**31, q - 2**32, q)  # the low 32 bits, as int32
    for key in q:
        if key < 0:
            continue
        h = kcount.home(int(key), plan.bits)
        while keys[h] not in (-1, key):
            h = (h + 1) & mask
        if keys[h] == -1:
            keys[h], index[h], distinct = key, distinct, distinct + 1
    assert distinct <= rows and distinct <= size // 2  # rows suffice; probes end
    out = np.zeros(nq, np.int64)
    reads = np.zeros(n, np.int64)
    span = kcount.THREADS * kcount.VECS
    for b in range(plan.grid):
        counts = np.zeros(plan.copies * rows, np.int64)
        idx = [np.arange(s * span, min(s * span + span, plan.n4))
               for s in range(b, plan.steps, plan.grid)]
        vec = np.concatenate(idx) if idx else np.zeros(0, np.int64)
        tok = (4 * vec[:, None] + np.arange(4)).reshape(-1)
        thread = np.repeat(vec % kcount.THREADS, 4)
        if b == 0:
            tail = np.arange(4 * plan.n4, n)
            assert len(tail) <= min(3, kcount.THREADS)
            tok = np.concatenate([tok, tail])
            thread = np.concatenate([thread, tail - 4 * plan.n4])
        np.add.at(reads, tok, 1)
        d = find_index(keys, index, stream[tok].astype(np.int64), plan.bits)
        lane = thread % 32 % plan.copies
        np.add.at(counts, (d * plan.copies + lane)[d >= 0], 1)
        mine = find_index(keys, index, q, plan.bits)
        rowsum = counts.reshape(rows, plan.copies).sum(1)
        out += np.where(mine >= 0, rowsum[mine], 0)
    return plan, out, reads


@pytest.mark.parametrize("n,nq,sms,occ", [
    (1, 1, 132, 8), (3, 105, 132, 8), (4097, 105, 132, 8), (5 * 4096 + 7, 105, 2, 4),
    (3 * 4096 * 4, 57, 1, 1), (20000, 4096, 3, 1), (9000, 8192, 2, 1), (0, 5, 132, 8),
])
def test_replay_reads_every_slot_once_and_equals_the_twin(n, nq, sms, occ):
    r = np.random.default_rng(n + nq)
    stream = r.integers(0, 3 * nq, n).astype(np.int32)
    stream[r.random(n) < 0.25] = -1
    queries = np.concatenate([r.integers(0, 3 * nq, nq - 1), [2**32 + 1]])[:nq]
    plan, got, reads = replay_count(stream, queries, sms, occ)
    assert (reads == 1).all()
    want = kcount.count_queries(torch.from_numpy(stream), torch.from_numpy(queries))
    np.testing.assert_array_equal(got, want.numpy())


def test_replay_on_a_trained_stream_with_a_hot_pair():
    tokens = row_local(11, 64, 60)
    pids = pid_stream(tokens)
    q = queries_of(pids, 105, 11)
    _, got, _ = replay_count(pids.numpy(), q.numpy(), 2, 3)
    np.testing.assert_array_equal(got, kcount.count_queries(pids, q).numpy())


def test_table_sizes_copies_and_grids():
    plans = {nq: kcount.count_plan(8, nq, 132, 1) for nq in (1, 64, 65, 105, 256, 257, 512,
                                                             4096, 4097, 8192)}
    assert [p.bits for p in plans.values()] == [8, 10, 11, 11, 12, 13, 13, 14, 14, 14]
    assert [p.copies for p in plans.values()] == [32, 32, 32, 32, 32, 16, 16, 2, 1, 1]
    p = kcount.count_plan(1 << 24, 105, 132, 8)  # the 1K trainer's pass
    assert (p.qbits, p.bits, p.copies, p.smem, p.n4, p.steps, p.blocks_per_sm, p.grid) == (
        7, 11, 32, 16384 + 16384, 1 << 22, 2048, 4, 528)
    p = kcount.count_plan(1 << 23, 57, 132, 8)
    assert (p.steps, p.grid) == (1024, 528)
    p = kcount.count_plan(4096, 8192, 132, 1)  # 160 KiB: one block an SM
    assert (p.smem, p.steps, p.blocks_per_sm, p.grid) == (131072 + 32768, 1, 1, 1)
    assert kcount.count_plan(3, 1, 132, 8).grid == 1  # the tail alone still launches


@pytest.mark.parametrize("n,nq", [(-1, 5), (8, 0), (8, kcount.MAX_QUERIES + 1)])
def test_plan_refuses_what_the_entry_refuses(n, nq):
    with pytest.raises(ValueError, match="takes no"):
        kcount.count_plan(n, nq, 132, 8)


# --------------------------------------------------------- the counter

@pytest.mark.parametrize("group,batch", [(1, 8), (1, 32), (4, 8)])
def test_verify_queries_sum_the_queries_of_every_pass(group, batch):
    """A pass of the single-merge loop asks for 2 columns of ``batch``
    rows, 2 x 4 entries of the hot token and the tie-break candidate; the
    grouped loop's passes ask for 3 columns (first member) or 2 without a
    hot token (re-selection), so the sum lies between."""
    from zigbpe_tpu_torch import train as t_train

    data = bytes(np.random.default_rng(5).integers(97, 107, 6000, dtype=np.uint8))
    tokens, length, seed = t_train.upload(data, "cpu")
    vocab = 300
    ub = core.pair_histogram(tokens, vocab, LAYOUT)
    M = vocab - core.VOCAB_START
    merges = torch.full((M, 3), -1, dtype=torch.int32)
    occupancy = torch.zeros(M, dtype=torch.int32)
    ts = TimeStats()
    core.train_chunk_lazy(tokens, length, ub, merges, occupancy, 0, vocab, 16,
                          select_batch=batch, merge_group=group, stats=ts)
    passes, queries = ts.counters["verify_passes"], ts.counters["verify_queries"]
    assert passes >= 1
    if group == 1:
        assert queries == (2 * batch + 2 * 4 + 1) * passes
    else:
        assert (2 * batch + 1) * passes <= queries <= (3 * batch + 2 * 4 + 1) * passes
