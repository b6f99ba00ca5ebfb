"""The program's counters in the harness's records, the readers of them,
and the set-up limit of ``run.py``."""

from __future__ import annotations

import json
import subprocess
import sys
import textwrap
import time

import pytest
import torch

from benchmark import loops, spec
from benchmark.record import Job, Run
from benchmark.trace import Tracer

from conftest import ROOT
from test_bench_readers import encode_run, slice_events, train_run

SEED = 2**33 + 9


def read(name, run):
    return spec.reader(ROOT, name)(run)


def kept_tokenizer():
    """``BasicTokenizer`` that keeps every instance made, in order."""
    from zigbpe_tpu_torch.models.basic_tokenizer import BasicTokenizer

    class Kept(BasicTokenizer):
        made: list = []

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            Kept.made.append(self)
    return Kept


def drive(root, workload, program, trace=False, seconds=0.3, ready=time.perf_counter):
    """The loop of ``workload`` on the CPU with ``program``: the run's
    records, after its check."""
    bench = spec.load(root)
    cell = spec.cell(bench, workload)
    run = Run(cell, spec.config(root, bench, cell["config"]), spec.traffic(root, cell["traffic"]))
    device = torch.device("cpu")
    tracer = Tracer(device) if trace else None
    ctx = loops.Context(root, SEED, seconds, device, tracer, ready, program)
    assert loops.KINDS[run.traffic["kind"]](run, ctx)().correct
    return run


@pytest.mark.parametrize("trace", [False, True])
def test_each_job_keeps_its_tokenizers_counters(tiny_root, trace):
    Kept = kept_tokenizer()
    run = drive(tiny_root, "tiny.train", Kept, trace=trace)
    jobs = Kept.made[1:]  # the first trains the warm-up
    assert len(jobs) == len(run.jobs) >= 1
    for job, tok in zip(run.jobs, jobs):
        stats = getattr(tok.time_stats, "_inner", tok.time_stats)
        assert job.counters == stats.counters
        assert job.counters is not stats.counters
        assert job.counters["merges"] == job.merges == len(tok.merges)
        assert job.counters["verify_passes"] >= 1 and job.counters["merge_passes"] >= 1
    assert run.jobs[0].traced == trace


@pytest.mark.parametrize("trace", [False, True])
def test_each_call_keeps_what_it_added_to_the_counters(tiny_root, trace):
    Kept = kept_tokenizer()
    at_open = {}

    def ready():
        at_open.update(Kept.made[-1].time_stats.counters)
        return time.perf_counter()

    run = drive(tiny_root, "tiny.enc", Kept, trace=trace, ready=ready)
    (tok,) = Kept.made
    assert at_open and len(run.calls) >= 1
    total = tok.time_stats.counters
    for name in total:
        assert sum(c.counters.get(name, 0) for c in run.calls) == total[name] - at_open.get(name, 0)
    for c in run.calls:
        rows = c.counters.get("encode_rows.kernel", 0) + c.counters.get("encode_rows.plain", 0)
        assert rows == c.docs


def test_a_program_without_counters_leaves_them_empty(tiny_root):
    from benchmark.controls import Control

    class Exact(Control):
        def train(self, data, vocab_size, verbose=False):
            from benchmark.reference import bpe

            self.merges = bpe.train(data, vocab_size, self.device)
            return self

    run = drive(tiny_root, "tiny.train", Exact)
    assert run.jobs and all(j.counters == {} for j in run.jobs)
    assert read("verify_passes_per_merge", run) is None
    assert read("merge_passes_per_merge", run) is None


def counted_run():
    """Three jobs with counters: the first traced, the others not."""
    jobs = [Job(1 << 24, 2.0, 1024, {}, traced=True,
                counters={"verify_passes": 700, "merge_passes": 300, "merges": 1024}),
            Job(1 << 24, 2.0, 1024, {},
                counters={"verify_passes": 1402, "merge_passes": 390, "merges": 1024,
                          "merge_tokens": 9}),
            Job(1 << 24, 2.0, 1000, {},
                counters={"verify_passes": 1300, "merge_passes": 400, "merges": 1000})]
    return Run({}, {}, {}, "cpu", setup_s=1.0, window_s=6.0, jobs=jobs)


@pytest.mark.parametrize("name,counter", [("verify_passes_per_merge", "verify_passes"),
                                          ("merge_passes_per_merge", "merge_passes")])
def test_the_counter_readers_sum_over_the_untraced_jobs(name, counter):
    run = counted_run()
    want = (run.jobs[1].counters[counter] + run.jobs[2].counters[counter]) / (1024 + 1000)
    assert read(name, run) == pytest.approx(want)
    # where every job was traced, every job counts
    only = Run({}, {}, {}, "cpu", jobs=run.jobs[:1])
    assert read(name, only) == pytest.approx(run.jobs[0].counters[counter] / 1024)
    # nothing to read: no counters, not this counter, no merges, no jobs
    assert read(name, train_run()) is None
    for job in run.jobs:
        del job.counters[counter]
    assert read(name, run) is None
    assert read(name, Run({}, {}, {}, "cpu", jobs=[Job(1, 1.0, 0, {}, counters={
        counter: 0, "merges": 0})])) is None
    assert read(name, Run({}, {}, {}, "cpu")) is None


def with_counters(run):
    for j in run.jobs:
        j.counters = {"verify_passes": 1402, "merge_passes": 390, "merges": j.merges}
    for c in run.calls:
        c.counters = {"encode_rows.kernel": c.docs}
    return run


EXISTING = [m["name"] for m in spec.load(ROOT)["end_to_end"] + spec.load(ROOT)["per_layer"]
            if m["name"] not in ("verify_passes_per_merge", "merge_passes_per_merge")]


@pytest.mark.parametrize("name", EXISTING)
def test_counters_change_no_other_reading(name):
    from benchmark import trace

    def summary():
        s = trace.Summary()
        trace.add_slice(s, slice_events())
        return s

    for make in (lambda: train_run(summary(), traced_merges=4.0), lambda: encode_run(summary()),
                 train_run, encode_run):
        assert read(name, with_counters(make())) == read(name, make())


LIMITED = """
import sys
import torch
from pathlib import Path
sys.path[:0] = [{root!r}]
from benchmark import run

run.limit_setup({limit})


def stall_in_setup():
    n = 0
    while True:
        n += 1


class Stalls:
    def __init__(self, *args, **kwargs):
        stall_in_setup()


program = Stalls if {stall} else None
result = run.run_cell(Path({tiny!r}), "tiny.enc", {seed}, {seconds}, False,
                      torch.device("cpu"), program, limited=True)
sys.exit(run.report(result))
"""


def limited_run(tiny_root, limit, stall, seconds=0.3):
    script = textwrap.dedent(LIMITED).format(root=str(ROOT), tiny=str(tiny_root), limit=limit,
                                             stall=stall, seed=SEED, seconds=seconds)
    t = time.monotonic()
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                         text=True, timeout=limit + 60)
    return out, time.monotonic() - t


def test_set_up_that_stalls_in_python_ends_at_the_limit(tiny_root):
    out, took = limited_run(tiny_root, limit=8, stall=True)
    assert out.returncode != 0
    assert took < 8 + 10
    assert out.stdout.strip() == ""
    lines = out.stderr.splitlines()
    named = next(i for i, line in enumerate(lines) if "SETUP_LIMIT_S = 8 s" in line)
    at = next(i for i, line in enumerate(lines) if line.startswith("Timeout ("))
    assert named < at and "stall_in_setup" in "\n".join(lines[at + 1:])


def test_a_run_under_the_limit_prints_its_result_and_its_window_is_not_limited(tiny_root):
    out, took = limited_run(tiny_root, limit=15, stall=False, seconds=16)
    assert out.returncode == 0, out.stderr[-3000:]
    assert took > 16 and "Timeout" not in out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["attempted"] >= 1
    assert list(result)[-1] == "compared"


@pytest.mark.card
def test_the_1k_training_cell_reads_both_counts(card):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "bpe_1k.train_16m",
                          "--seed", str(2**33 + 23), "--seconds", "5", "--trace", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    for name in ("verify_passes_per_merge", "merge_passes_per_merge"):
        assert result["metrics"][name]["unit"] == "count"
        assert 0 < result["metrics"][name]["value"] < 10
