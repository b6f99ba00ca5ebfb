"""The controls of the comparison that decides ``correct``: the plain
reference put in the program's place with a guarantee of the configuration
broken, driven through a whole run of the cell at its own size, so that the
run's own check judges it.

    python3 benchmark/controls.py --workload <name> --seeds <n> [<n> ...] [--seconds <s>]

* training: pair counts rounded to bfloat16 before the largest is taken
  (the configuration states exact counts);
* encoding: every occurrence of a pair (a, a) merged at once instead of
  leftmost first.

Each seed prints one JSON line: the run's ``correct``, ``failed`` and the
numbers it compared, each beside its limit. A control must read
``correct: false``. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0]).resolve() == ROOT / "benchmark":
    sys.path[0] = str(ROOT)


class Control:
    """``BasicTokenizer``'s interface over the plain reference, with the
    controls' faults: training counts pairs in bfloat16, encoding merges
    every (a, a) occurrence at once."""

    def __init__(self, merges=None, device="cpu"):
        self.merges = list(merges or [])
        self.device = device
        self.time_stats = SimpleNamespace(phases={})

    def train(self, data: bytes, vocab_size: int, verbose: bool = False) -> "Control":
        import torch

        from benchmark.reference import bpe

        self.merges = bpe.train(data, vocab_size, self.device, count_dtype=torch.bfloat16)
        return self

    def encode_batch(self, docs) -> list[list[int]]:
        from benchmark.reference import bpe

        return [r.tolist() for r in bpe.encode(docs, self.merges, self.device, leftmost=False)]


def control_run(root: Path, workload: str, seed: int, device, seconds: float = 5.0) -> dict:
    """One run of ``workload`` with ``Control`` in the program's place."""
    from benchmark.run import run_cell

    t = time.perf_counter()
    r = run_cell(root, workload, seed, seconds, False, device, program=Control)
    return {"workload": workload, "seed": seed, "correct": r["correct"], "failed": r["failed"],
            "attempted": r["attempted"], "compared": r["compared"], "notes": r["notes"],
            "seconds": round(time.perf_counter() - t, 3)}


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for seed in args.seeds:
        print(json.dumps(control_run(ROOT, args.workload, seed, torch.device(args.device),
                                     args.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
