"""The kinds of traffic a mix file can name, and the loop each drives.

Each kind makes its inputs from the seed, warms up every path its window
takes, calls ``ctx.ready()`` when the window opens, runs the window as one
caller, records each job or call in ``run``, and returns the check that
compares what the window produced with the plain reference.

* ``train_jobs``: whole training jobs back to back on one seeded corpus, a
  new tokenizer each. The job still running when the window's time is up
  finishes and counts. In a traced run the first job profiles every
  ``every``-th call of the TimeStats phase ``phase`` from the ``first``,
  and counts the merges those calls make from the lines the trainer
  prints with ``verbose`` after each chunk.
* ``encode_calls``: ``encode_batch`` calls in a closed loop over a pool of
  calls made from the seed, with one frozen table. In a traced run
  the first ``trace_calls`` calls are one profiled slice.

Each job keeps a copy of its tokenizer's counters (``time_stats.counters``)
once it has ended, and each call what it added to them, whatever names the
program records. Both are read outside the timed interval of the job or
call.

The program is ``BasicTokenizer`` unless the context puts another class
with its interface in its place, as the controls do.
"""

from __future__ import annotations

import contextlib
import io
import random
import time
from dataclasses import dataclass
from pathlib import Path

import torch

from benchmark import corpus
from benchmark.record import Call, Job, Run
from benchmark.reference import bpe


@dataclass
class Context:
    root: Path
    seed: int
    seconds: float
    device: torch.device
    tracer: object = None  # trace.Tracer in a traced run
    ready: object = time.perf_counter  # called as the window opens; returns its start
    program: object = None  # the tokenizer class under test; None: BasicTokenizer

    def tokenizer(self):
        if self.program is not None:
            return self.program
        from zigbpe_tpu_torch.models.basic_tokenizer import BasicTokenizer

        return BasicTokenizer


@dataclass
class Checked:
    """The numbers compared, each with its limit; what else the check
    counted; and how many jobs or calls were wrong."""

    numbers: dict
    notes: dict
    failed: int

    @property
    def correct(self) -> bool:
        return all(value <= limit for value, limit in self.numbers.values())


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class SlicedPhases:
    """A tokenizer's TimeStats that also profiles chosen calls of one phase:
    the ``first`` and every ``every``-th after it. ``merges`` counts the
    ``merge i/M`` lines given to ``printed`` between the end of a profiled
    call and the start of the next call of the phase: the merges that the
    profiled chunks made, as the trainer's ``verbose`` prints them. Every
    other attribute, the counters included, is the inner TimeStats'."""

    def __init__(self, inner, tracer, phase: str, every: int, first: int):
        self._inner, self._tracer = inner, tracer
        self._phase, self._every, self._first = phase, every, first
        self.calls = 0
        self.traced = 0
        self.merges = 0
        self._counting = False

    def printed(self, line: str) -> None:
        if self._counting and line.startswith("merge "):
            self.merges += 1

    def __getattr__(self, name):
        return getattr(self._inner, name)

    @contextlib.contextmanager
    def phase(self, name, device=None):
        due = False
        if name == self._phase:
            due = self.calls >= self._first and (self.calls - self._first) % self._every == 0
            self.calls += 1
            self._counting = False
        if not due:
            with self._inner.phase(name, device):
                yield
            return
        self.traced += 1
        with self._tracer.slice(), self._inner.phase(name, device):
            yield
        self._counting = True


class Lines(io.TextIOBase):
    """A text stream that hands each whole line written to ``sink``."""

    def __init__(self, sink):
        self._sink, self._part = sink, ""

    def write(self, text: str) -> int:
        *whole, self._part = (self._part + text).split("\n")
        for line in whole:
            self._sink(line)
        return len(text)


def counters(tok) -> dict:
    """A copy of the program's counters, empty where it keeps none."""
    return dict(getattr(tok.time_stats, "counters", {}))


def merges_differing(got, ref) -> int:
    return sum(tuple(g) != tuple(r) for g, r in zip(got, ref)) + abs(len(got) - len(ref))


def train_jobs(run: Run, ctx: Context):
    Tokenizer = ctx.tokenizer()
    vocab, tr = run.config["vocab_size"], run.traffic
    data = corpus.seeded_corpus(tr["corpus_bytes"], ctx.seed)
    Tokenizer(device=ctx.device).train(data[:tr["warmup_bytes"]], vocab)
    _sync(ctx.device)
    answers = []
    start = ctx.ready()
    while True:
        tok = Tokenizer(device=ctx.device)
        sliced = None
        printing = contextlib.nullcontext()
        if ctx.tracer is not None and not run.jobs:
            sliced = tok.time_stats = SlicedPhases(tok.time_stats, ctx.tracer, **tr["trace"])
            printing = contextlib.redirect_stdout(Lines(sliced.printed))
        t0 = time.perf_counter()
        with printing:
            tok.train(data, vocab, verbose=sliced is not None)
        _sync(ctx.device)
        t1 = time.perf_counter()
        phases = {k: (v.total_s, v.calls) for k, v in tok.time_stats.phases.items()}
        run.jobs.append(Job(len(data), t1 - t0, len(tok.merges), phases, sliced is not None,
                            counters(tok)))
        if sliced is not None:
            run.traced_merges = sliced.merges
        answers.append(tok.merges)
        del tok
        if t1 - start >= ctx.seconds:
            break
    run.window_s = t1 - start

    def check() -> Checked:
        t = time.perf_counter()
        ref = bpe.train(data, vocab, ctx.device)
        wrong = [merges_differing(a, ref) for a in answers]
        return Checked({"merges_differing": (sum(wrong), 0)},
                       {"jobs_compared": len(answers), "reference_merges": len(ref),
                        "reference_s": round(time.perf_counter() - t, 3)},
                       sum(w > 0 for w in wrong))
    return check


def encode_calls(run: Run, ctx: Context):
    tr = run.traffic
    table = corpus.load_merges(ctx.root / run.config["table"])
    pool = corpus.documents(tr, ctx.seed)
    tok = ctx.tokenizer()(table, device=ctx.device)
    # warm-up: the first call of each size class of the longest document
    firsts: dict = {}
    for i, docs in enumerate(pool):
        firsts.setdefault(max(map(len, docs)).bit_length(), i)
    for i in sorted(firsts.values()):
        tok.encode_batch(pool[i])
    _sync(ctx.device)
    longest = max(range(len(pool)), key=lambda i: max(map(len, pool[i])))
    # compared after the window: a sample of calls drawn from the seed, and
    # the first call of the pool's longest document
    pick, sample, first_longest = random.Random(ctx.seed), [], None
    k = tr["check_calls"]
    trace_calls = tr["trace_calls"] if ctx.tracer is not None else 0
    i = 0
    with contextlib.ExitStack() as traced:
        start = ctx.ready()
        while True:
            if i == 0 and trace_calls:
                traced.enter_context(ctx.tracer.slice())
            p = i % len(pool)
            before = counters(tok)
            t0 = time.perf_counter()
            out = tok.encode_batch(pool[p])
            t1 = time.perf_counter()
            added = {k: n - before.get(k, 0) for k, n in counters(tok).items()}
            run.calls.append(Call(sum(map(len, pool[p])), len(pool[p]), sum(map(len, out)),
                                  t1 - t0, i < trace_calls, added))
            if len(sample) < k:
                sample.append((p, out))
            elif (j := pick.randrange(i + 1)) < k:
                sample[j] = (p, out)
            if p == longest and first_longest is None:
                first_longest = (p, out)
            i += 1
            if i == trace_calls:
                traced.close()
            if t1 - start >= ctx.seconds:
                break
    run.window_s = t1 - start
    compared = sample + ([first_longest] if first_longest is not None else [])
    del tok, out

    def check() -> Checked:
        t = time.perf_counter()
        refs = bpe.encode([d for p, _ in compared for d in pool[p]], table, ctx.device)
        bad, at = [], 0
        for p, out in compared:
            ref = refs[at:at + len(pool[p])]
            at += len(ref)
            bad.append(abs(len(out) - len(ref)) + sum(
                len(g) != len(r) or g != r.tolist() for g, r in zip(out, ref)))
        return Checked({"docs_differing": (sum(bad), 0)},
                       {"calls_compared": len(compared), "docs_compared": len(refs),
                        "reference_s": round(time.perf_counter() - t, 3)},
                       sum(b > 0 for b in bad))
    return check


KINDS = {"train_jobs": train_jobs, "encode_calls": encode_calls}
