"""BASELINE.json config 2: 1024 merges on a 100 MB corpus, one card.

    python -m zigbpe_tpu_torch.scripts.run_config2 [MB] [MERGES] [--device cuda]

Port of ``scripts/run_config2.py``. The conformance corpus tiled to ``MB``
MiB (100) is staged (``upload_s``) and trained to ``MERGES`` merges (1024)
twice on the card: a cold run on a clone of the staged stream (its span
holds the kernels' builds when the process has not built them), then a warm
run, whose merges must equal the cold run's. The merges round-trip through
``merges.txt`` in a temporary directory, and ``conforms_to_native`` holds
them against the native single-core C++ trainer on the same bytes (the
first divergence goes to stderr). Prints one JSON line and writes it to
``results/config2.json``.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import torch

from .. import train
from ..measure import card_value, device_field, host_ms, size_label, write_result
from ..native import fastio
from ..ops.core import resolve_device
from ..probes.budget import tiled_corpus
from ..utils import serde


def run(device="cuda", nbytes: int = 100 << 20, merges: int = 1024) -> dict:
    """Train ``nbytes`` of the tiled corpus to ``merges`` merges cold and
    warm, round-trip the table and compare it with the native trainer's;
    returns the JSON line's fields."""
    dev = resolve_device(device)
    if not fastio.available():
        raise RuntimeError("the native library did not build: no conformance check")
    vocab = 256 + merges
    data = tiled_corpus(nbytes)

    (tokens, length, ub_block), upload_ms = host_ms(lambda: train.upload(data, dev), dev)
    cold = tokens.clone()
    got, cold_ms = host_ms(lambda: train.train_device(cold, length, vocab,
                                                      ub_seed_block=ub_block), dev)
    del cold
    if len(got) != merges:
        raise RuntimeError(f"expected {merges} merges, got {len(got)}")
    again, warm_ms = host_ms(lambda: train.train_device(tokens, length, vocab,
                                                        ub_seed_block=ub_block), dev)
    del tokens
    if again != got:
        raise RuntimeError("the warm run gave other merges than the cold run")

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "merges.txt"
        serde.save(got, path)
        if serde.load(path) != got:
            raise RuntimeError("merges.txt does not round-trip")

    native, native_ms = host_ms(lambda: fastio.train(data, vocab), torch.device("cpu"))
    conform = native == got
    if not conform:
        i = next((i for i, (a, b) in enumerate(zip(native, got)) if a != b),
                 min(len(native), len(got)))
        a = native[i] if i < len(native) else None
        b = got[i] if i < len(got) else None
        print(f"first divergence at merge {i}: native={a} device={b}", file=sys.stderr)

    warm_s, cold_s, native_s = warm_ms / 1e3, cold_ms / 1e3, native_ms / 1e3
    return {
        "metric": f"config2_train_{merges}merges_{size_label(nbytes)}MB",
        "value": card_value(dev, len(data) / warm_s / 1e6, 3),
        "unit": "MB/s/chip",
        "warm_s": card_value(dev, warm_s, 2),
        "cold_s": card_value(dev, cold_s, 2),
        "cold_mbps": card_value(dev, len(data) / cold_s / 1e6, 3),
        "upload_s": card_value(dev, upload_ms / 1e3, 2),
        "serde_roundtrip": True,
        "conforms_to_native": conform,
        "native_s": round(native_s, 2),
        "native_mbps": round(len(data) / native_s / 1e6, 3),
        "vs_native": card_value(dev, native_s / warm_s, 2),
        "device": device_field(dev),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m zigbpe_tpu_torch.scripts.run_config2",
        description="BASELINE.json config 2: train MERGES merges on MB MiB on one card.",
    )
    parser.add_argument("mb", nargs="?", type=int, default=100, help="MiB of corpus")
    parser.add_argument("merges", nargs="?", type=int, default=1024, help="merges to train")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) runs the kernels; cpu runs their plain twins")
    args = parser.parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as err:
        parser.error(str(err))
    result = run(args.device, args.mb << 20, args.merges)
    print(json.dumps(result))
    write_result("config2", result)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
