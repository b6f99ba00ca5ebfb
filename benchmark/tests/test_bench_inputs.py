"""The seeded inputs: corpora, documents and the frozen table."""

from __future__ import annotations

import json
from collections import Counter

import numpy as np
import pytest

from benchmark import corpus
from benchmark.reference import bpe

from conftest import ROOT

BIG = 2**33 + 1  # seeds reach past 32 signed bits


@pytest.mark.parametrize("nbytes", [1, 1000, 185_768, 400_001])
def test_corpus_has_the_stated_length(nbytes):
    assert len(corpus.seeded_corpus(nbytes, BIG)) == nbytes


def test_corpus_is_fixed_by_its_seed_and_differs_across_seeds():
    a = corpus.seeded_corpus(300_000, BIG)
    assert a == corpus.seeded_corpus(300_000, BIG)
    assert a != corpus.seeded_corpus(300_000, BIG + 1)


def test_corpus_copies_are_the_conformance_lines_reordered():
    text = corpus.SEED_TEXT.read_bytes()
    one = corpus.seeded_corpus(len(text), 7)
    assert one != text
    assert Counter(one.splitlines()) == Counter(text.splitlines())


def _traffic(name):
    return json.loads((ROOT / "benchmark" / "traffic" / f"{name}.json").read_text())


def test_bulk_documents_are_consecutive_slices_of_one_corpus():
    tr = {**_traffic("encode_bulk"), "pool_calls": 2, "docs_per_call": 3}
    pool = corpus.documents(tr, BIG)
    assert [len(c) for c in pool] == [3, 3]
    assert all(len(d) == 32768 for c in pool for d in c)
    assert b"".join(d for c in pool for d in c) == corpus.seeded_corpus(6 * 32768, BIG)
    assert pool == corpus.documents(tr, BIG)
    assert pool != corpus.documents(tr, BIG + 1)


# a mix of calls of 100 documents with lognormal lengths at random offsets
SERVING = {"kind": "encode_calls", "docs_per_call": 100, "pool_calls": 256,
           "lengths": {"dist": "lognormal", "median": 2048, "sigma": 1.0, "min": 16,
                       "max": 32768, "seed": 0},
           "source": "random_offsets", "corpus_bytes": 16777216}


def test_serving_calls_have_one_set_of_lengths_in_an_order_drawn_from_the_seed():
    tr = {**SERVING, "pool_calls": 40, "corpus_bytes": 1 << 20}
    a, b = corpus.documents(tr, BIG), corpus.documents(tr, BIG + 1)
    shapes = [sorted(sorted(len(d) for d in call) for call in pool) for pool in (a, b)]
    assert shapes[0] == shapes[1]
    assert [[len(d) for d in call] for call in a] != [[len(d) for d in call] for call in b]
    lens = corpus.doc_lengths(tr["pool_calls"] * tr["docs_per_call"], tr["lengths"])
    assert sorted(len(d) for call in a for d in call) == sorted(lens)
    full = corpus.doc_lengths(256 * 100, tr["lengths"])
    assert full.min() >= 16 and full.max() <= 32768
    assert 1800 <= np.median(full) <= 2300


def test_the_frozen_table_is_the_plain_trainers_on_the_conformance_corpus():
    committed = corpus.load_merges(ROOT / "benchmark" / "data" / "bpe_1k.merges.txt")
    assert committed == bpe.train(corpus.SEED_TEXT.read_bytes(), 1280)
    assert len(committed) == 1024


def test_the_corpus_copy_is_the_conformance_corpus():
    copy = corpus.SEED_TEXT.read_bytes()
    assert copy == (ROOT / "tests" / "data" / "taylorswift.txt").read_bytes()
    assert (len(copy), copy.count(b"\n")) == (185_768, 988)


def test_the_traced_chunks_merges_are_counted_from_the_trainers_lines():
    """A job to vocab 400 makes 144 merges in chunks of 64, 64 and 16;
    profiling the first and the third counts 80 merges."""
    import contextlib

    import torch

    from benchmark import loops
    from benchmark.record import Run

    class Tracer:
        slices = 0

        @contextlib.contextmanager
        def slice(self):
            self.slices += 1
            yield

    tracer = Tracer()
    run = Run({}, {"vocab_size": 400},
              {"kind": "train_jobs", "corpus_bytes": 16384, "warmup_bytes": 1024,
               "trace": {"phase": "merge_rounds", "every": 2, "first": 0}})
    loops.train_jobs(run, loops.Context(ROOT, 7, 0.0, torch.device("cpu"), tracer))
    assert run.jobs[0].merges == 144 and run.jobs[0].traced
    assert tracer.slices == 2 and run.traced_merges == 80
