"""The plain reference against the program on the CPU, and its controls."""

from __future__ import annotations

import pytest
import torch

from benchmark import corpus
from benchmark.reference import bpe

from conftest import ROOT

TEXT = corpus.SEED_TEXT.read_bytes()


def test_reference_trains_the_golden_merges():
    golden = corpus.load_merges(ROOT / "tests" / "data" / "merges.txt")
    assert bpe.train(TEXT, 300) == golden


@pytest.mark.parametrize("seed", [1, 2**33 + 3])
def test_reference_trains_what_the_program_trains(seed):
    from zigbpe_tpu_torch.models.basic_tokenizer import BasicTokenizer

    data = corpus.seeded_corpus(24_000, seed)
    tok = BasicTokenizer(device="cpu").train(data, 420)
    assert bpe.train(data, 420) == tok.merges


def test_reference_encodes_what_the_program_encodes():
    from zigbpe_tpu_torch.models.basic_tokenizer import BasicTokenizer

    table = corpus.load_merges(ROOT / "benchmark" / "data" / "bpe_1k.merges.txt")[:200]
    docs = [TEXT[i * 997:i * 997 + 37 * i] for i in range(12)] + [b"aaaaaaa", b"  \n\n\n", b""]
    got = BasicTokenizer(table, device="cpu").encode_batch(docs)
    assert [r.tolist() for r in bpe.encode(docs, table)] == got


def test_leftmost_first_resolves_runs_of_one_pair():
    s = torch.tensor([5, 5, 5, 5, 5, 7, 5, 5])
    assert bpe.merge(s, 5, 5, 9).tolist() == [9, 9, 5, 7, 9]
    assert bpe.merge(s, 5, 5, 9, leftmost=False).tolist() == [9, 7, 9]


def test_training_control_fails():
    """Pair counts rounded to bfloat16 pick other merges on the whole
    conformance corpus to 1K merges."""
    ref = bpe.train(TEXT, 1280)
    control = bpe.train(TEXT, 1280, count_dtype=torch.bfloat16)
    assert sum(a != b for a, b in zip(ref, control)) > 0


def test_encoding_control_fails():
    """Every occurrence of a pair (a, a) merged at once changes documents."""
    table = corpus.load_merges(ROOT / "benchmark" / "data" / "bpe_1k.merges.txt")
    docs = [TEXT[i * 4096:(i + 1) * 4096] for i in range(16)]
    ref = bpe.encode(docs, table)
    control = bpe.encode(docs, table, leftmost=False)
    assert sum(not torch.equal(a, b) for a, b in zip(ref, control)) > 0


@pytest.mark.parametrize("workload,seed", [("tiny.train", 11),
                                           ("bpe_1k.enc_tiny", 2**33 + 5)])
def test_a_control_in_the_programs_place_reads_not_correct(run_tiny, workload, seed):
    """The controls, driven through a whole run, fail the run's own check.
    At 32 KiB the bfloat16 counts tie the top pair on some corpora only;
    seed 11 is one (the card's cells fail on every seed). The encoding
    control needs the pairs (a, a) that only the whole 1K table has, and
    documents long enough to hold runs of them."""
    from benchmark.controls import Control

    r = run_tiny(workload, seconds=1.0, seed=seed, program=Control)
    assert r["correct"] is False and r["failed"] >= 1
    assert all(c["value"] > c["limit"] for c in r["compared"].values())
