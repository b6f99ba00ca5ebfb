"""The two seeds of the trainer's upper-bound table, and the two whole-file
reads, timed in turns on one corpus.

    python -m zigbpe_tpu_torch.probes seed [--mb 32] [--vocab 512] [--runs 5]

1. The conformance corpus tiled to ``nbytes`` (as ``bench.py`` tiles it) is
   written to a temporary file, and read back by the native reader
   (``fastio.read_file``) and by Python's ``Path.read_bytes``
   (``fileio.read_file``), in turns; the file is in the page cache after the
   first read.
2. The corpus is staged at the trainer's capacity (``train.upload``), then
   the lazy path's V*V table is seeded both ways, in turns: on the host
   (``fastio.byte_pair_hist`` of the bytes, then ``train._place_byte_hist``
   on the device, which the trainer does in its two ``count_pairs``
   phases) and on the device (``core.pair_histogram`` of the staged stream,
   the seed without the native library). The two tables must be equal.

Every row is the median of ``runs`` runs after one warm-up, with the
range, on the host clock with the device synchronised at the end of each
run: the time the trainer's ``count_pairs`` phases see. The host seed is
also split into its count on the host and its placement.
"""

from __future__ import annotations

import tempfile
from pathlib import Path

import torch

from .. import train
from ..measure import host_ms
from ..native import fastio
from ..ops import core
from ..ops.core import resolve_device
from ..utils import fileio
from . import device_line, spread
from .budget import tiled_corpus


def in_turns(fns: dict, device: torch.device, runs: int) -> dict:
    """ms of each of ``fns`` in ``runs`` rounds after a warm-up round; the
    order turns round by round (a, b, b, a, ...). Returns {name: [ms]}."""
    names = list(fns)
    times = {name: [] for name in names}
    for r in range(runs + 1):
        for name in names if r % 2 else reversed(names):
            ms = host_ms(fns[name], device)[1]
            if r:
                times[name].append(ms)
    return times


def run(device="cuda", nbytes: int = 32 << 20, vocab: int = 512, runs: int = 5) -> dict:
    """Time both reads and both seeds; print and return the rows, each
    (median, min, max) ms. Raises if the native library does not build or
    the seeds differ."""
    dev = resolve_device(device)
    if not fastio.available():
        raise RuntimeError("the native library did not build: no host seed to time")
    if not 256 < vocab <= train.LAZY_VOCAB_MAX:
        raise ValueError(f"vocab {vocab} must be above 256 and seed a lazy table")
    data = tiled_corpus(nbytes)
    line = device_line(dev)
    print(f"seed probe: {len(data)} bytes, vocab {vocab}, {runs} runs in turns; {line}")

    rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "corpus.bin"
        path.write_bytes(data)
        reads = in_turns({"read_file native": lambda: fastio.read_file(path),
                          "read_file Python": lambda: fileio.read_file(path)},
                         torch.device("cpu"), runs)
        if fastio.read_file(path) != data:
            raise RuntimeError("the native reader gave other bytes")
    rows.update({name: spread(ms) for name, ms in reads.items()})

    tokens, _, block = train.upload(data, dev)
    placed = train._place_byte_hist(block, vocab)
    exact = core.pair_histogram(tokens, vocab)
    if not torch.equal(placed, exact):
        raise RuntimeError("the host seed differs from the device seed")
    del placed, exact
    count_ms, place_ms = [], []

    def host_seed():
        hist, ms = host_ms(lambda: fastio.byte_pair_hist(data), torch.device("cpu"))
        count_ms.append(ms)
        ub, ms = host_ms(lambda: train._place_byte_hist(torch.from_numpy(hist).to(dev), vocab),
                        dev)
        place_ms.append(ms)
        return ub

    seeds = in_turns({"host seed (count + place)": host_seed,
                      "device seed (pair_histogram)": lambda: core.pair_histogram(tokens, vocab)},
                     dev, runs)
    rows.update({name: spread(ms) for name, ms in seeds.items()})
    rows["host count (byte_pair_hist)"] = spread(count_ms[-runs:])
    rows["host placement"] = spread(place_ms[-runs:])
    for name, (med, lo, hi) in rows.items():
        print(f"  {name:30s} {med:10.3f} ms  ({lo:.3f}-{hi:.3f})")
    return rows
