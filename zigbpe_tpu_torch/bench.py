"""Headline benchmark of the port: BPE training throughput on one card.

    python -m zigbpe_tpu_torch.bench [--device cuda]

Port of the JAX repo's ``bench.py``, with its environment: ``BENCH_MB``
(32, MiB of the conformance corpus tiled), ``BENCH_MERGES`` (256, so vocab
512) and ``BENCH_RUNS`` (3). The protocol:

1. a full training run (``train.train``) as warm-up: ``warmup_s``, which
   holds the kernels' builds and the first CUDA set-up;
2. staging (``train.upload``: the bytes to the card and the host byte-pair
   seed of the table), timed as ``upload_s``;
3. ``BENCH_RUNS`` runs of ``train.train_device`` on the staged corpus, each
   on a clone made outside its span (the trainer consumes its stream);
   ``value`` is their median in MB/s and every run must give the merges of
   the warm-up;
4. batched encode: a 1024-merge table trained by the native trainer on the
   first MiB, scheduled by ``schedule_merges(cap=32)`` outside the span,
   then ``encode_rows_grouped`` over the staged corpus as rows of 32768
   tokens (one warm-up, the best of two runs);
5. the native single-core C++ trainer (``native.fastio.train``) on the first
   8 MiB, at least three runs and up to six while the best three spread
   more than 20% (the host-load guard): ``native_baseline_mbps`` from the
   best, ``vs_baseline`` the median's ratio to it.

Every timed span ends in ``torch.cuda.synchronize()`` and is read on the
host clock. Prints one JSON line with the JAX line's keys and ``device``
(the card's name and power limit). On the CPU (``--device cpu``) the plain
twins run for checking and every field that times the card is null.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics

import torch

from . import measure, train
from .measure import card_value, device_field, host_ms, host_runs, replay_rows, size_label
from .native import fastio
from .ops.core import resolve_device
from .probes.budget import tiled_corpus

BASELINE_SLICE = 8 << 20


def native_baseline(data: bytes, vocab: int) -> list[float]:
    """Seconds of each native training run on ``data``: three, then up to
    three more while the best three spread more than 20%."""
    runs = []
    for _ in range(6):
        _, ms = host_ms(lambda: fastio.train(data, vocab), torch.device("cpu"))
        runs.append(ms / 1e3)
        if len(runs) >= 3:
            best3 = sorted(runs)[:3]
            if best3[2] <= best3[0] * 1.2:
                break
    return runs


def run(device="cuda", nbytes: int = 32 << 20, merges: int = 256, runs: int = 3) -> dict:
    """Run the protocol on ``nbytes`` of the tiled corpus to ``merges``
    merges; returns the JSON line's fields. Raises if the native library
    does not build or a run gives other merges than the warm-up."""
    dev = resolve_device(device)
    if not fastio.available():
        raise RuntimeError("the native library did not build: no baseline and no host seed")
    vocab = 256 + merges
    data = tiled_corpus(nbytes)
    mb = len(data) / 1e6

    want, warm_ms = host_ms(lambda: train.train(data, vocab, chunk_rounds=64, device=dev), dev)
    if len(want) != merges:
        raise RuntimeError(f"expected {merges} merges, got {len(want)}")
    (tokens, length, ub_block), upload_ms = host_ms(lambda: train.upload(data, dev), dev)

    runs_mbps = []
    for _ in range(runs):
        toks = tokens.clone()
        got, ms = host_ms(lambda: train.train_device(
            toks, length, vocab, ub_seed_block=ub_block, chunk_rounds=64), dev)
        del toks
        if got != want:
            raise RuntimeError("a timed run gave other merges than the warm-up")
        runs_mbps.append(len(data) / (ms / 1e3) / 1e6)
    median_mbps = statistics.median(runs_mbps)

    gt, gl = measure.scheduled_table(data, dev)
    row = measure.ENCODE_ROW
    rows = tokens[: tokens.shape[0] // row * row].view(-1, row)
    enc_runs, _ = replay_rows(rows, gt, gl, lambda fn: host_runs(fn, dev, 2))
    del rows, tokens

    base_slice = data[:BASELINE_SLICE]
    native_mbps = len(base_slice) / min(native_baseline(base_slice, vocab)) / 1e6
    upload_s = upload_ms / 1e3
    return {
        "metric": f"bpe_train_device_throughput_{merges}merges_{size_label(nbytes)}MB",
        "value": card_value(dev, median_mbps, 3),
        "unit": "MB/s/chip",
        "vs_baseline": card_value(dev, median_mbps / native_mbps, 3),
        "runs_mbps": card_value(dev, runs_mbps, 3),
        "best_mbps": card_value(dev, max(runs_mbps), 3),
        "upload_s": card_value(dev, upload_s, 3),
        "end_to_end_mbps": card_value(dev, mb / (upload_s + mb / median_mbps), 3),
        "warmup_s": card_value(dev, warm_ms / 1e3, 3),
        "native_baseline_mbps": round(native_mbps, 3),
        "encode_mbps_1kmerge_batched": card_value(dev, max(enc_runs), 3),
        "encode_runs_mbps": card_value(dev, enc_runs, 3),
        "device": device_field(dev),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m zigbpe_tpu_torch.bench",
        description="Training throughput on one card (BENCH_MB, BENCH_MERGES, BENCH_RUNS).",
    )
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) runs the kernels; cpu runs their plain twins")
    args = parser.parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as err:
        parser.error(str(err))
    result = run(args.device, int(os.environ.get("BENCH_MB", "32")) << 20,
                 int(os.environ.get("BENCH_MERGES", "256")),
                 int(os.environ.get("BENCH_RUNS", "3")))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
