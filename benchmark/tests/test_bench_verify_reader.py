"""The reader of ``verify_kernel_ms_per_merge`` on synthetic profiler
events: the verify kernel's device time over the traced merges, and nothing
where the trace holds no such kernel (a program without it)."""

from __future__ import annotations

import pytest

from benchmark import spec, trace
from benchmark.record import Job, Run
from benchmark.trace import Event, Summary

from conftest import ROOT

COUNT = ("void (anonymous namespace)::count_queries_kernel<true>(int4 const*, int const*, "
         "long long, long long, long long, void const*, int, int, int*)")
MERGE = "void (anonymous namespace)::merge_kernel<4, 0u>(int*, int const*, int, long long)"
ENCODE = "void encode_rows_kernel(int const*, int*, int*, int, int const*, int const*, int, int)"


def read(run):
    return spec.reader(ROOT, "verify_kernel_ms_per_merge")(run)


def traced(events, merges=4.0):
    s = Summary()
    trace.add_slice(s, [Event(trace.MARKER, False, 0, 10_000_000, 1), *events])
    jobs = [Job(16 << 20, 13.0, 1024, {"merge_rounds": (12.0, 16)}, traced=True)]
    return Run({}, {}, {}, "NVIDIA H100 80GB HBM3", setup_s=1.0, window_s=40.0, jobs=jobs,
               trace=s, traced_merges=merges)


def test_the_kernels_device_time_per_traced_merge():
    run = traced([Event(COUNT, True, 1_000_000, 1_050_000), Event(MERGE, True, 2_000_000, 3_000_000),
                  Event(COUNT, True, 4_000_000, 4_030_000)])
    assert read(run) == pytest.approx(0.080 / 4)


def test_nothing_without_the_kernel_or_the_merges():
    assert read(traced([Event(MERGE, True, 0, 1_000), Event(ENCODE, True, 0, 1_000),
                        Event("void at::native::reduce_kernel<512>", True, 0, 1_000)])) is None
    assert read(traced([Event(COUNT, True, 0, 1_000)], merges=0.0)) is None
    run = traced([Event(COUNT, True, 0, 1_000)])
    run.trace = None
    assert read(run) is None


def test_the_kernel_name_matches_no_other_kernel():
    from importlib.util import module_from_spec, spec_from_file_location

    path = ROOT / "benchmark" / "metrics" / "verify_kernel_ms_per_merge.py"
    mod_spec = spec_from_file_location("verify_reader", path)
    mod = module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    assert mod.KERNEL in COUNT
    assert mod.KERNEL not in MERGE and mod.KERNEL not in ENCODE
