"""python -m zigbpe_tpu_torch.probes budget|floor|pipeline [--device cuda]"""

from __future__ import annotations

import argparse

from . import budget, floor, pipeline


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m zigbpe_tpu_torch.probes",
        description="Measure how a merge pass spends its time on the card.",
    )
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) runs the kernels; cpu runs their plain twins")
    parser.add_argument("--runs", type=int, default=5, help="timed runs per row")
    sub = parser.add_subparsers(dest="probe", required=True)
    b = sub.add_parser("budget", help="ablated merge passes over a real training run")
    b.add_argument("--mb", type=int, default=32, help="corpus size in MiB")
    b.add_argument("--np", type=int, default=16, dest="np_passes", help="passes replayed")
    sub.add_parser("floor", help="blocked copy against block size and dtype")
    p = sub.add_parser("pipeline", help="copies shaped like the merge grid, and the merge")
    p.add_argument("--loop", action="store_true", help="64 chained copies against 64 merges")
    args = parser.parse_args(argv)
    if args.probe == "budget":
        budget.run(args.device, nbytes=args.mb << 20, np_passes=args.np_passes, runs=args.runs)
    elif args.probe == "floor":
        floor.run(args.device, runs=args.runs)
    else:
        pipeline.run(args.device, loop=args.loop, runs=args.runs)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
