"""The benchmark's inputs, made from ``--seed``: corpora, documents and the
frozen merge table.

A corpus is the conformance text (``data/taylorswift.txt``) with its lines
shuffled by the seed in each copy, the copies laid end to end and the
result cut to size. Documents are slices of such a corpus, laid out as the
traffic file says.
"""

from __future__ import annotations

import random
from pathlib import Path

import numpy as np

DATA = Path(__file__).resolve().parent / "data"
SEED_TEXT = DATA / "taylorswift.txt"


def seeded_corpus(nbytes: int, seed: int) -> bytes:
    """``nbytes`` bytes of copies of the conformance text, each with its
    lines in an order drawn from ``seed``."""
    lines = SEED_TEXT.read_bytes().splitlines(keepends=True)
    rng = random.Random(seed)
    parts, total = [], 0
    while total < nbytes:
        rng.shuffle(lines)
        part = b"".join(lines)
        parts.append(part)
        total += len(part)
    return b"".join(parts)[:nbytes]


def doc_lengths(count: int, spec: dict) -> np.ndarray:
    """``count`` document lengths in bytes under ``spec``: ``{"dist":
    "fixed", "bytes": n}``, or ``{"dist": "lognormal", "median", "sigma",
    "min", "max", "seed"}``, drawn from the spec's own seed, so that every
    run has the same lengths."""
    if spec["dist"] == "fixed":
        return np.full(count, spec["bytes"], np.int64)
    if spec["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    fixed = np.random.default_rng(spec["seed"])
    lens = fixed.lognormal(np.log(spec["median"]), spec["sigma"], count)
    return np.clip(np.rint(lens), spec["min"], spec["max"]).astype(np.int64)


def documents(traffic: dict, seed: int) -> list[list[bytes]]:
    """The pool of calls of an ``encode_calls`` traffic mix: ``pool_calls``
    lists of ``docs_per_call`` documents. Every seed gets the same calls'
    worth of lengths (each call the same set of lengths); the seed orders
    the calls and the documents in each, and picks the text.
    ``"source": "consecutive"`` cuts one seeded corpus into documents in
    order; ``"random_offsets"`` takes each document from an offset drawn
    from the seed in a corpus of ``corpus_bytes``."""
    calls, per = traffic["pool_calls"], traffic["docs_per_call"]
    rng = np.random.default_rng([seed, 1])
    lens = doc_lengths(calls * per, traffic["lengths"]).reshape(calls, per)
    lens = rng.permuted(lens[rng.permutation(calls)], axis=1).reshape(-1)
    if traffic["source"] == "consecutive":
        text = seeded_corpus(int(lens.sum()), seed)
        ends = np.cumsum(lens)
        docs = [text[e - k:e] for e, k in zip(ends.tolist(), lens.tolist())]
    elif traffic["source"] == "random_offsets":
        text = seeded_corpus(traffic["corpus_bytes"], seed)
        starts = rng.integers(0, len(text) - lens + 1)
        docs = [text[s:s + k] for s, k in zip(starts.tolist(), lens.tolist())]
    else:
        raise ValueError(f"unknown document source {traffic['source']!r}")
    return [docs[i:i + per] for i in range(0, calls * per, per)]


def load_merges(path: Path) -> list[tuple[int, int, int]]:
    """A merge table in the ``first,second,new`` lines of ``merges.txt``."""
    return [tuple(int(v) for v in line.split(","))
            for line in path.read_text().splitlines() if line]
