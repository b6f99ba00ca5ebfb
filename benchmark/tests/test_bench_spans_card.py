"""On the card: the program's spans reach a profiled run as host events on
the profiler's own clock, and never as device operations.

    python -m pytest benchmark/tests/test_bench_spans_card.py -m card
"""

from __future__ import annotations

import pytest

from benchmark import trace

from conftest import ROOT

TRAIN_SPANS = {"train.select", "train.upkeep", "train.merge"}
ENCODE_SPANS = {"encode.pad", "encode.schedule", "encode.kernel", "encode.copy", "encode.lists"}


def _profiled(card, block):
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(card)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        block()
        torch.cuda.synchronize(card)
    return trace.profiler_events(prof)


@pytest.mark.card
def test_every_span_is_a_host_event_and_none_a_device_operation(card):
    from zigbpe_tpu_torch.models.basic_tokenizer import BasicTokenizer

    text = (ROOT / "benchmark" / "data" / "taylorswift.txt").read_bytes()
    tok = BasicTokenizer(device=card)
    docs = [text[i * 4096:(i + 1) * 4096] for i in range(8)]

    def block():
        tok.train(text[:65536], 300)
        tok.encode_batch(docs)

    BasicTokenizer(device=card).train(text[:4096], 300)  # builds the kernels unprofiled
    events = _profiled(card, block)
    host = {e.name for e in events if not e.device}
    device = {e.name for e in events if e.device}
    assert TRAIN_SPANS | ENCODE_SPANS <= host
    assert any("encode_rows_kernel" in n for n in device)
    assert any("merge_kernel" in n for n in device)
    assert not (TRAIN_SPANS | ENCODE_SPANS) & device
    assert tok.time_stats.counters["encode_rows.kernel"] == len(docs)
    assert tok.time_stats.counters["merges"] == len(tok.merges)


@pytest.mark.card
def test_a_span_contains_the_device_interval_of_the_kernel_it_waits_for(card):
    import torch

    from zigbpe_tpu_torch.utils.profiling import TimeStats

    x = torch.arange(1 << 26, device=card)
    ts = TimeStats()

    def block():
        with ts.span("probe.launch"):
            x.cumsum(0)
            torch.cuda.synchronize(card)

    block()  # the first launch, unprofiled
    events = _profiled(card, block)
    span = [e for e in events if e.name == "probe.launch"]
    kernels = [e for e in events if e.device and not trace.is_copy(e.name)]
    assert len(span) == 1 and not span[0].device and kernels
    assert all(span[0].start <= k.start < k.end <= span[0].end for k in kernels)
    assert "probe.launch" not in {e.name for e in events if e.device}
