"""BASELINE.json config 3 at spec: encode a 1 GiB corpus with a frozen
1024-merge table, batched as rows of 32768 tokens, on one card.

    python -m zigbpe_tpu_torch.scripts.run_config3 [MB] [--device cuda]

Port of ``scripts/run_config3.py``. The table is trained by the native
trainer on the first MiB and scheduled by ``schedule_merges(cap=32)``
(``fused_passes`` groups). The corpus tiled to ``MB`` MiB (1024) is cut to
whole rows and staged with ``core.pad_tokens`` (bytes cross as uint8 and
widen on the card: ``upload_s``), then viewed as [rows, 32768] with no
second copy. One warm-up replay, then two timed ones; each run's output is
freed before the next (at 1 GiB the rows take 4.3 GB and one output as
much). ``tokens_out`` and ``compression`` depend only on the bytes: on the
1 GiB they must read 307,958,775 and 3.4866, as the TPU run recorded. Prints
one JSON line and writes it to ``results/config3.json``.
"""

from __future__ import annotations

import argparse
import json

from .. import measure
from ..measure import (card_value, device_field, host_runs, replay_rows, scheduled_table,
                       size_label, stage_rows, write_result)
from ..native import fastio
from ..ops.core import resolve_device
from ..probes.budget import tiled_corpus


def run(device="cuda", nbytes: int = 1 << 30) -> dict:
    """Replay the table over ``nbytes`` of the tiled corpus as rows of
    ``measure.ENCODE_ROW`` tokens; returns the JSON line's fields."""
    dev = resolve_device(device)
    if not fastio.available():
        raise RuntimeError("the native library did not build: no table to replay")
    data = tiled_corpus(nbytes)
    gt, gl = scheduled_table(data, dev)
    rows, upload_ms = stage_rows(data, measure.ENCODE_ROW, dev)
    runs, tokens_out = replay_rows(rows, gt, gl, lambda fn: host_runs(fn, dev, 2))
    B, row = rows.shape

    return {
        "metric": f"encode_device_throughput_1kmerge_{size_label(nbytes)}MB",
        "value": card_value(dev, max(runs), 3),
        "unit": "MB/s/chip",
        "runs_mbps": card_value(dev, runs, 3),
        "rows": B,
        "row_tokens": row,
        "fused_passes": int(gl.shape[0]),
        "upload_s": card_value(dev, upload_ms / 1e3, 3),
        "tokens_out": tokens_out,
        "compression": round(B * row / tokens_out, 4),
        "device": device_field(dev),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m zigbpe_tpu_torch.scripts.run_config3",
        description="BASELINE.json config 3: encode MB MiB as rows of 32768 tokens on one card.",
    )
    parser.add_argument("mb", nargs="?", type=int, default=1024, help="MiB of corpus")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) runs the kernel; cpu runs its plain twin")
    args = parser.parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as err:
        parser.error(str(err))
    result = run(args.device, args.mb << 20)
    print(json.dumps(result))
    write_result("config3", result)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
