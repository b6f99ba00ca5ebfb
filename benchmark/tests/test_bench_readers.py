"""The metric readers and the trace's arithmetic, on synthetic records and
profiler events."""

from __future__ import annotations


import pytest

from benchmark import roofline, spec, trace
from benchmark.record import Call, Job, Run
from benchmark.trace import Event, Summary

from conftest import ROOT

CARD = "NVIDIA H100 80GB HBM3"
MERGE = "void (anonymous namespace)::merge_kernel<4, 0u>(int*, int const*, int, long long)"
ENCODE = "void encode_rows_kernel(int const*, int*, int*, int, int const*, int const*, int, int)"


def read(name, run):
    return spec.reader(ROOT, name)(run)


def ms(x):
    return int(x * 1e6)  # ms -> ns


def slice_events():
    """A 10 ms slice: a kernel 1-3 ms, an overlapping one 2-4 ms, a copy to
    the host 4-6 ms, a fill 8-9 ms. The host runs aten::item over 3.5-5 ms
    and aten::full over 7-8.5 ms (with a nested runtime call), on the
    marker's thread; another thread's event is ignored."""
    return [
        Event(trace.MARKER, False, 0, ms(10), 1),
        Event(trace.MARKER, True, 0, ms(10)),
        Event(MERGE, True, ms(1), ms(3)),
        Event("void at::native::reduce_kernel<512>", True, ms(2), ms(4)),
        Event("Memcpy DtoH (Device -> Pageable)", True, ms(4), ms(6)),
        Event("Memset (Device)", True, ms(8), ms(9)),
        Event("aten::item", False, ms(3.5), ms(5), 1),
        Event("aten::full", False, ms(7), ms(8.5), 1),
        Event("cudaLaunchKernel", False, ms(7.2), ms(7.4), 1),
        Event("aten::other_thread", False, ms(0), ms(10), 2),
    ]


def test_a_slice_is_folded_into_busy_time_ops_and_idle_gaps():
    s = Summary()
    trace.add_slice(s, slice_events())
    assert s.slices == 1 and s.window_s == pytest.approx(0.010)
    # kernels 1-4 ms, fill 8-9 ms; the copy to the host and the marker do not count
    assert s.busy_s == pytest.approx(0.004)
    assert s.op_s[MERGE] == pytest.approx(0.002)
    assert trace.MARKER not in s.op_s
    assert s.kernel_count() == 2 and s.op_count[MERGE] == 1
    # idle 0-1, 4-8, 9-10: aten::item 4-5, aten::full 7-8, the rest host
    assert s.idle_s["aten::item"] == pytest.approx(0.001)
    assert s.idle_s["aten::full"] == pytest.approx(0.001)
    assert s.idle_s[trace.HOST] == pytest.approx(0.004)
    assert "cudaLaunchKernel" not in s.idle_s and "aten::other_thread" not in s.idle_s
    assert sum(s.idle_s.values()) == pytest.approx(s.window_s - s.busy_s)


def test_slices_add_up_and_a_session_without_marker_adds_nothing():
    s = Summary()
    trace.add_slice(s, slice_events())
    trace.add_slice(s, slice_events())
    trace.add_slice(s, [Event(MERGE, True, 0, ms(1))])
    assert s.slices == 2 and s.busy_s == pytest.approx(0.008)
    b = s.breakdown(top=2)
    assert len(b["device_ops"]) == 2 and len(b["idle_gaps"]) == 2
    assert b["idle_gaps"][0] == [trace.HOST, pytest.approx(0.008)]


def test_union_merges_overlaps():
    assert trace.union([(5, 6), (1, 3), (2, 4), (4, 4)]) == [(1, 4), (5, 6)]


def train_run(trace_summary=None, traced_merges=0.0):
    jobs = [Job(16 << 20, 13.0, 1024, {"initial_tokens": (0.010, 1), "count_pairs": (0.020, 2),
                                       "merge_rounds": (12.0, 16)}, traced=True),
            Job(16 << 20, 12.0, 1024, {"initial_tokens": (0.008, 1), "count_pairs": (0.016, 2),
                                       "merge_rounds": (10.24, 16)}),
            Job(16 << 20, 14.5, 1024, {"initial_tokens": (0.012, 1), "count_pairs": (0.024, 2),
                                       "merge_rounds": (10.24, 16)})]
    return Run({}, {}, {}, CARD, setup_s=12.5, window_s=39.6, jobs=jobs,
               trace=trace_summary, traced_merges=traced_merges)


def test_whole_job_window_arithmetic():
    run = train_run()
    # three whole jobs, the last past the window's time, over the window's wall
    assert read("train_MBps", run) == pytest.approx(3 * (16 << 20) / 39.6 / 1e6)
    assert read("setup_s", run) == 12.5
    # span metrics leave out the profiled job
    assert read("upload_ms", run) == pytest.approx(30.0)
    assert read("rounds_ms_per_merge", run) == pytest.approx(10.0)
    assert read("encode_MBps", run) is None


def test_train_device_readers():
    s = Summary()
    trace.add_slice(s, slice_events())
    run = train_run(s, traced_merges=4.0)
    assert read("launches_per_merge", run) == pytest.approx(0.5)
    assert read("merge_kernel_ms_per_merge", run) == pytest.approx(0.5)
    assert read("idle_share.train", run) == pytest.approx(0.6)


def test_device_readers_read_nothing_without_a_device_trace():
    s = Summary()
    trace.add_slice(s, [Event(trace.MARKER, False, 0, ms(10), 1),
                        Event("aten::eq", False, ms(1), ms(2), 1)])
    for run in (train_run(None, 4.0), train_run(s, 4.0), train_run(s, 0.0)):
        for name in ("launches_per_merge", "merge_kernel_ms_per_merge", "idle_share.train"):
            assert read(name, run) is None


def encode_run(trace_summary=None):
    calls = [Call(1024 * 32768, 1024, 9_000_000, 0.8, traced=True),
             Call(1024 * 32768, 1024, 9_000_000, 0.9, traced=True),
             Call(1024 * 32768, 1024, 9_000_000, 0.85)]
    return Run({}, {}, {}, CARD, setup_s=9.0, window_s=2.6, calls=calls, trace=trace_summary)


def test_encode_readers():
    run = encode_run()
    assert read("encode_MBps", run) == pytest.approx(3 * 1024 * 32768 / 2.6 / 1e6)
    s = Summary(slices=1, window_s=2.0, busy_s=0.004, op_s={ENCODE: 0.0033},
                op_count={ENCODE: 2})
    run = encode_run(s)
    bytes_ = 2 * (4 * 1024 * 32768 + 4 * 9_000_000 + 4 * 1024)
    assert read("encode_kernel_roofline", run) == pytest.approx(100 * bytes_ / 3.35e12 / 0.0033)
    assert read("idle_share.encode", run) == pytest.approx(0.998)


def test_roofline_bytes_count_each_token_and_id_once():
    calls = [Call(nbytes=100, docs=3, ids=40, seconds=0.0), Call(10, 1, 10, 0.0)]
    assert roofline.encode_bytes(calls) == 4 * (100 + 40 + 3) + 4 * (10 + 10 + 1)
    assert roofline.hbm_bytes_per_s(CARD) == 3.35e12
    assert roofline.hbm_bytes_per_s("cpu") is None


@pytest.mark.parametrize("twin,base", [("idle_share.encode", "idle_share.train")])
def test_a_metric_under_another_name_reads_the_same(twin, base):
    s = Summary()
    trace.add_slice(s, slice_events())
    for run in (train_run(s, traced_merges=4), encode_run(s), train_run()):
        assert read(twin, run) == read(base, run)
