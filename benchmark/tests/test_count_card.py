"""On the card: the verify pass's kernel (``csrc/count.cu``) equals its
plain twin, run on the card too, and the trainer reaches it.

    python -m pytest benchmark/tests/test_count_card.py -m card
"""

from __future__ import annotations

import pytest

from conftest import ROOT


def _pids(card, n: int, seed: int, hot_share: float = 0.0, pad_share: float = 0.1):
    """``n`` pair ids below 1280^2 from ``seed``: ``pad_share`` of the slots
    PAD, ``hot_share`` of them pair 97 * 1280 + 98."""
    import torch

    g = torch.Generator(device=card).manual_seed(seed)
    ids = torch.randint(0, 1280 * 1280, (n,), generator=g, device=card, dtype=torch.int32)
    u = torch.rand(n, generator=g, device=card)
    ids = torch.where(u < hot_share, 97 * 1280 + 98, ids)
    return torch.where(u > 1 - pad_share, -1, ids)


def _queries(pids, nq: int, seed: int):
    """``nq`` int64 queries: the hot pair, pairs drawn from the stream (so
    they occur), one that occurs nowhere, repeats."""
    import torch

    g = torch.Generator(device=pids.device).manual_seed(seed)
    held = pids[pids >= 0]
    pick = held[torch.randint(0, max(held.numel(), 1), (nq,), generator=g,
                              device=pids.device)] if held.numel() else pids.new_zeros(nq)
    q = pick.long()
    q[0], q[-1] = 97 * 1280 + 98, 1280 * 1280  # the hot pair; no pair id reaches V*V
    if nq > 2:
        q[1] = q[0]
    return q


def _same(pids, q):
    import torch

    from zigbpe_tpu_torch.ops.kernels import count as kcount

    got = kcount.count_queries(pids, q)
    want = kcount.count_queries_reference(pids, q)
    torch.cuda.synchronize(pids.device)
    assert torch.equal(got, want), (got - want).abs().max()
    return got


@pytest.mark.card
def test_kernel_equals_twin_with_a_hot_slot(card):
    from zigbpe_tpu_torch.ops.kernels import count as kcount

    pids = _pids(card, 1 << 24, 2**33 + 1, hot_share=0.3)
    q = _queries(pids, 105, 1)
    before = kcount.count_queries.launches
    got = _same(pids, q)
    assert kcount.count_queries.launches == before + 1
    assert int(got[0]) > 0.29 * (1 << 24) and int(got[1]) == int(got[0]) and int(got[-1]) == 0
    _same(pids, q.int())  # int32 queries, widened by the wrapper


# the twin holds a Q x min(n, 2^20) comparison and its int64 cast: wide
# query sets only on short streams
@pytest.mark.parametrize("n,nq", [(n, nq) for n in (0, 1, 3, 1000, 4096 * 4 + 7)
                                  for nq in (1, 105, 4096, 8192)]
                         + [((1 << 23) + 3, 1), ((1 << 23) + 3, 105)])
@pytest.mark.card
def test_every_length_and_query_count(card, n, nq):
    pids = _pids(card, n, n + nq, hot_share=0.05)
    _same(pids, _queries(pids, nq, nq))


@pytest.mark.card
def test_an_all_pad_stream_counts_nothing(card):
    import torch

    pids = torch.full((1 << 22,), -1, dtype=torch.int32, device=card)
    q = torch.arange(105, device=card)
    assert _same(pids, q).tolist() == [0] * 105


@pytest.mark.card
def test_the_c_geometry_is_the_python_plan(card):
    from zigbpe_tpu_torch.ops.kernels import count as kcount

    for n, nq in ((1 << 24, 105), (1 << 23, 57), (3, 1), (0, 5), (4096, 8192), (1 << 20, 512)):
        got = kcount.device_plan(n, nq)
        want = kcount.count_plan(n, nq, got.sms, got.blocks_per_sm)
        assert got == want, (n, nq, got, want)


@pytest.mark.card
def test_training_launches_the_kernel_and_learns_the_cpu_merges(card):
    from zigbpe_tpu_torch.models.basic_tokenizer import BasicTokenizer
    from zigbpe_tpu_torch.ops.kernels import count as kcount
    from zigbpe_tpu_torch.probes.budget import tiled_corpus

    text = tiled_corpus(1 << 20)
    kcount.count_queries.launches = 0
    tok = BasicTokenizer(device=card).train(text, 400)
    assert kcount.count_queries.launches > 0
    assert tok.time_stats.counters["verify_passes"] == kcount.count_queries.launches
    assert tok.merges == BasicTokenizer(device="cpu").train(text, 400).merges
