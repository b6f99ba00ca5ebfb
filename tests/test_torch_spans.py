"""Spans and counters of the port's ``TimeStats``: their aggregates, the
report's section of its own, the spans and counters the trainer loop and
``encode_batch`` record, the profiler ranges they open, and the benchmark's
readers of the idle time under them. CPU only; the card's check that a span
is a host event on the profiler's clock is
``benchmark/tests/test_bench_spans_card.py``."""

from __future__ import annotations

import time
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import spec, trace
from benchmark.record import Call, Run
from benchmark.trace import Event, Summary
from zigbpe_tpu.utils.profiling import TimeStats as JStats
from zigbpe_tpu_torch import train as t_train
from zigbpe_tpu_torch.models.basic_tokenizer import BasicTokenizer
from zigbpe_tpu_torch.models import oracle
from zigbpe_tpu_torch.utils.profiling import TimeStats

REPO = Path(__file__).resolve().parents[1]
TEXT = (REPO / "tests" / "data" / "taylorswift.txt").read_bytes()

TRAIN_SPANS = {"train.select", "train.upkeep", "train.merge"}
ENCODE_SPANS = {"encode.pad", "encode.schedule", "encode.kernel", "encode.copy", "encode.lists"}


# ------------------------------------------------------------ aggregates

def test_spans_nest_under_a_phase_with_self_time_and_parent():
    ts = TimeStats()
    with ts.phase("merge_rounds"):
        for _ in range(2):
            with ts.span("outer"):
                time.sleep(0.002)
                with ts.span("inner"):
                    time.sleep(0.003)
        with ts.span("sibling"):
            pass
    outer, inner, sibling = ts.spans["outer"], ts.spans["inner"], ts.spans["sibling"]
    assert (outer.calls, inner.calls, sibling.calls) == (2, 2, 1)
    assert (outer.parent, inner.parent, sibling.parent) == ("merge_rounds", "outer",
                                                            "merge_rounds")
    assert outer.total_s >= inner.total_s >= 0.006
    assert outer.self_s == pytest.approx(outer.total_s - inner.total_s, abs=1e-9)
    assert outer.self_s >= 0.004
    assert inner.self_s == inner.total_s
    assert ts.phases["merge_rounds"].total_s >= outer.total_s + sibling.total_s
    assert list(ts.phases) == ["merge_rounds"] and ts.phases["merge_rounds"].calls == 1
    assert not ts._open


def test_a_span_outside_any_phase_has_no_parent_and_counters_add():
    ts = TimeStats()
    with ts.span("alone"):
        pass
    ts.count("rows", 3)
    ts.count("rows")
    ts.count("passes")
    assert ts.spans["alone"].parent is None and ts.spans["alone"].calls == 1
    assert ts.counters == {"rows": 4, "passes": 1}
    assert not ts.phases


def test_a_span_that_raises_is_still_recorded_and_closed():
    ts = TimeStats()
    with pytest.raises(ValueError):
        with ts.phase("p"), ts.span("failing"):
            raise ValueError
    assert ts.spans["failing"].calls == 1 and not ts._open


def test_null_time_stats_record_nothing_and_open_no_range():
    ts = TimeStats.null()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with ts.phase("p"), ts.span("null.span"):
            torch.ones(4).sum()
        ts.count("rows", 5)
    assert not ts.phases and not ts.spans and not ts.counters
    assert "null.span" not in {e.name for e in trace.profiler_events(prof)}


def test_a_span_is_a_profiler_host_event_and_a_phase_is_none():
    ts = TimeStats()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with ts.phase("a_phase"), ts.span("probe.span"):
            torch.ones(4).sum()
    events = trace.profiler_events(prof)
    spans = [e for e in events if e.name == "probe.span"]
    assert len(spans) == 1 and not spans[0].device and spans[0].end > spans[0].start
    assert "a_phase" not in {e.name for e in events}
    inside = [e for e in events if e.name == "aten::sum"]
    assert inside and all(spans[0].start <= e.start and e.end <= spans[0].end for e in inside)


# ---------------------------------------------------------------- report

def _filled(cls):
    ts = cls()
    with ts.phase("count_pairs"):
        pass
    with ts.phase("merge_rounds"):
        pass
    for name, total in (("count_pairs", 0.25), ("merge_rounds", 1.5)):
        ts.phases[name].total_s = total
    ts._start = None  # the report's total is then the sum of the phases
    return ts


def test_report_without_spans_is_the_jax_report_byte_for_byte():
    port, jax = _filled(TimeStats), _filled(JStats)
    assert port.report() == jax.report()
    assert "Spans" not in port.report() and "Counters" not in port.report()


@pytest.mark.parametrize("what", ["span", "counter", "both"])
def test_report_adds_a_section_only_for_what_was_recorded(what):
    ts = _filled(TimeStats)
    if what in ("span", "both"):
        with ts.span("train.select"):
            pass
    if what in ("counter", "both"):
        ts.count("verify_passes", 7)
    lines = ts.report().splitlines()
    head = _filled(JStats).report().splitlines()
    assert lines[:len(head)] == head
    rest = lines[len(head):]
    spans = ["Spans (host clock, no device sync):"]
    counters = ["Counters:", "  verify_passes: 7"]
    if what == "counter":
        assert rest == counters
    else:
        assert rest[:1] == spans and rest[1].startswith("  train.select: ")
        assert rest[1].endswith(" ms self, 1 calls, in -")
        assert rest[2:] == (counters if what == "both" else [])


# --------------------------------------------------------- trainer loop

@pytest.mark.parametrize("vocab", [300, 9000])
def test_train_records_the_loop_spans_and_counters(vocab):
    data = TEXT if vocab <= t_train.LAZY_VOCAB_MAX else TEXT[:400]
    tok = BasicTokenizer(device="cpu").train(data, vocab)
    ts = tok.time_stats
    assert tok.merges == oracle.train(data, vocab)
    lazy = vocab <= t_train.LAZY_VOCAB_MAX
    assert set(ts.spans) == (TRAIN_SPANS if lazy else TRAIN_SPANS - {"train.upkeep"})
    assert all(acc.parent == "merge_rounds" for acc in ts.spans.values())
    c = ts.counters
    assert c["merges"] == len(tok.merges)
    assert c["merge_passes"] <= c["merges"] <= 4 * c["merge_passes"]
    assert c["merge_passes"] == ts.spans["train.merge"].calls
    assert c["merge_tokens"] >= c["merge_passes"] * t_train.MIN_CAPACITY
    if lazy:
        assert c["verify_passes"] >= c["merge_passes"]
        assert ts.spans["train.upkeep"].calls == c["merges"]
        assert ts.spans["train.select"].calls >= c["merges"]
    else:
        assert "verify_passes" not in c and c["merge_passes"] == c["merges"]
        assert ts.spans["train.select"].calls == c["merges"]
    report = ts.report()
    assert "Spans (host clock, no device sync):" in report and "  merges: " in report


def test_the_chunk_loops_run_without_stats():
    """``stats`` is optional: without it the loops record nothing and give
    the same merges."""
    from zigbpe_tpu_torch.ops import core

    data = TEXT[:3000]
    tokens, length, seed = t_train.upload(data, "cpu")
    tokens2 = tokens.clone()
    V = 300
    ub = core.pair_histogram(tokens, V)
    M = V - core.VOCAB_START
    out = []
    for stats in (None, TimeStats()):
        merges = torch.full((M, 3), core.PAD, dtype=torch.int32)
        occ = torch.zeros((M,), dtype=torch.int32)
        got = core.train_chunk_lazy(tokens if stats is None else tokens2, length, ub.clone(),
                                    merges, occ, 0, vocab_size=V, max_rounds=16,
                                    merge_group=4, stats=stats)
        out.append(got[3][:got[5]].tolist())
    assert out[0] == out[1] and len(out[0]) == 16
    assert stats.counters["merges"] == 16


# ---------------------------------------------------------- serving front

@pytest.mark.parametrize("route", ["kernel", "plain"])
def test_encode_batch_records_its_spans_and_rows(route):
    merges = oracle.train(TEXT[:4000], 300)
    docs = [TEXT[:700], TEXT[900:1000], TEXT[2000:2600]]
    tok = BasicTokenizer(merges, device="cpu")
    kw = {} if route == "kernel" else {"row_length": 768}  # under the kernel's rows
    for _ in range(2):
        out = tok.encode_batch(docs, **kw)
    assert out == [oracle.encode(d, merges) for d in docs]
    ts = tok.time_stats
    assert set(ts.spans) == ENCODE_SPANS
    assert all(acc.calls == 2 and acc.parent is None for acc in ts.spans.values())
    ids = 2 * sum(map(len, out))
    assert ts.counters == {f"encode_rows.{route}": 2 * len(docs),
                           "encode_ids.shared": ids, "encode_ids.made": 0}
    assert not ts.phases


def test_encode_batch_row_counters_sum_to_the_rows_across_routes():
    merges = oracle.train(TEXT[:4000], 300)
    tok = BasicTokenizer(merges, device="cpu")
    a = tok.encode_batch([TEXT[:500]] * 3)
    b = tok.encode_batch([TEXT[:500]] * 2, row_length=640)
    assert tok.time_stats.counters == {"encode_rows.kernel": 3, "encode_rows.plain": 2,
                                       "encode_ids.shared": sum(map(len, a + b)),
                                       "encode_ids.made": 0}
    assert tok.time_stats.spans["encode.lists"].calls == 2


# ---------------------------------------------------------------- readers

TRAIN_READERS = {"idle_ms_per_merge.select": "train.select",
                 "idle_ms_per_merge.upkeep": "train.upkeep",
                 "idle_ms_per_merge.merge": "train.merge"}
ENCODE_READERS = {"idle_ms_per_call.pad": "encode.pad",
                  "idle_ms_per_call.copy": "encode.copy",
                  "idle_ms_per_call.lists": "encode.lists"}


def _read(name, run):
    return spec.reader(REPO, name)(run)


def _run(summary, merges=0, calls=()):
    run = Run({}, {}, {}, "NVIDIA H100 80GB HBM3", trace=summary)
    run.traced_merges = merges
    run.calls = list(calls)
    return run


def _summary(busy_s, idle):
    return Summary(slices=1, window_s=1.0, busy_s=busy_s, idle_s=dict(idle))


@pytest.mark.parametrize("name", sorted(TRAIN_READERS))
def test_train_span_readers(name):
    span = TRAIN_READERS[name]
    s = _summary(0.7, {span: 0.064, "host": 0.2, "aten::item": 0.03})
    assert _read(name, _run(s, merges=32)) == pytest.approx(2.0)
    # no device work, no merges counted, no such span, no trace: nothing to read
    assert _read(name, _run(_summary(0.0, {span: 0.5}), merges=32)) is None
    assert _read(name, _run(s, merges=0)) is None
    assert _read(name, _run(_summary(0.7, {"host": 0.3}), merges=32)) is None
    assert _read(name, _run(None, merges=32)) is None


@pytest.mark.parametrize("name", sorted(ENCODE_READERS))
def test_encode_span_readers(name):
    span = ENCODE_READERS[name]
    traced = [Call(100, 2, 50, 0.5, True) for _ in range(4)]
    untraced = [Call(100, 2, 50, 0.5, False) for _ in range(3)]
    s = _summary(0.003, {span: 2.0, "host": 0.1})
    assert _read(name, _run(s, calls=traced + untraced)) == pytest.approx(500.0)
    assert _read(name, _run(_summary(0.0, {span: 2.0}), calls=traced)) is None
    assert _read(name, _run(s, calls=untraced)) is None
    assert _read(name, _run(_summary(0.003, {"host": 2.0}), calls=traced)) is None
    assert _read(name, _run(None, calls=traced)) is None


def test_span_gaps_are_named_after_the_span_in_a_slice():
    """A slice whose host runs two sibling spans around operators: the idle
    time inside each span goes to the span, the rest to ``host``."""
    def ms(x):
        return int(x * 1e6)

    events = [
        Event(trace.MARKER, False, 0, ms(10), 1),
        Event("kernel", True, ms(1), ms(2)),
        Event("train.select", False, ms(2), ms(6), 1),
        Event("aten::item", False, ms(3), ms(5), 1),
        Event("kernel", True, ms(5), ms(6)),
        Event("train.merge", False, ms(6), ms(9), 1),
    ]
    s = Summary()
    trace.add_slice(s, events)
    assert s.idle_s["train.select"] == pytest.approx(0.003)
    assert s.idle_s["train.merge"] == pytest.approx(0.003)
    assert s.idle_s[trace.HOST] == pytest.approx(0.002)
    assert "aten::item" not in s.idle_s
    assert _read("idle_ms_per_merge.select", _run(s, merges=3)) == pytest.approx(1.0)


@pytest.mark.parametrize("name", sorted(TRAIN_READERS) + sorted(ENCODE_READERS))
def test_span_metrics_are_listed_for_their_cells(name):
    bench = spec.load(REPO)
    entry = next(m for m in bench["per_layer"] if m["name"] == name)
    cell, moves, layer = (("bpe_1k.train_16m", "train_MBps", "trainer loop")
                          if name in TRAIN_READERS else
                          ("bpe_1k.encode_bulk", "encode_MBps", "serving front"))
    assert entry == {"name": name, "unit": "ms", "better": "lower", "source": "program_span",
                     "layer": layer, "moves": moves, "workloads": [cell]}
