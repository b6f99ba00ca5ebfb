"""python -m zigbpe_tpu_torch.probes [--device cuda] [--runs 5]
budget|floor|pipeline|alu16|hist|lowering|launch|seed|breakdown|encode|select_batch"""

from __future__ import annotations

import argparse

from . import (alu16, breakdown, budget, encode, floor, hist, launch, lowering, pipeline,
               seed, select_batch)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m zigbpe_tpu_torch.probes",
        description="Measure the port's layers on the card: merge pass, seeds, training, encode.",
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
    for name, what in (("alu16", "the merge kernel's op mix in int32 and packed int16"),
                       ("hist", "a blocked copy with one-hot histograms on the tensor cores")):
        s = sub.add_parser(name, help=what)
        s.add_argument("--tokens", type=int, default=1 << 25, help="tokens per array")
        s.add_argument("--passes", type=int, default=32, help="chained passes per run")
    sub.add_parser("lowering", help="the TPU build's lowering checks against their twins")
    la = sub.add_parser("launch", help="where a kernel wrapper's host time goes, piece by piece")
    la.add_argument("--calls", type=int, default=10_000, help="calls per timed span")
    se = sub.add_parser("seed", help="the host and device seeds of the table, and file reads")
    se.add_argument("--mb", type=int, default=32, help="corpus size in MiB")
    se.add_argument("--vocab", type=int, default=512, help="the seeded table's vocab size")
    br = sub.add_parser("breakdown", help="a training round split into selection, merge and rest")
    br.add_argument("--mb", type=int, default=32, help="corpus size in MiB")
    br.add_argument("--rounds", type=int, default=64, help="rounds of each variant")
    en = sub.add_parser("encode", help="the encode kernel over the corpus in rows")
    en.add_argument("--mb", type=int, default=32, help="corpus size in MiB")
    en.add_argument("--row", type=int, default=32768, help="tokens a row")
    sb = sub.add_parser("select_batch", help="training with verify batches 8, 16 and 32")
    sb.add_argument("--mb", type=int, default=8, help="corpus size in MiB")
    sb.add_argument("--vocab", type=int, default=1280, help="the trained vocab size")
    args = parser.parse_args(argv)
    if args.probe == "budget":
        budget.run(args.device, nbytes=args.mb << 20, np_passes=args.np_passes, runs=args.runs)
    elif args.probe == "floor":
        floor.run(args.device, runs=args.runs)
    elif args.probe == "pipeline":
        pipeline.run(args.device, loop=args.loop, runs=args.runs)
    elif args.probe == "alu16":
        alu16.run(args.device, n_tokens=args.tokens, passes=args.passes, runs=args.runs)
    elif args.probe == "hist":
        hist.run(args.device, n_tokens=args.tokens, passes=args.passes, runs=args.runs)
    elif args.probe == "lowering":
        lowering.run(args.device)
    elif args.probe == "seed":
        seed.run(args.device, nbytes=args.mb << 20, vocab=args.vocab, runs=args.runs)
    elif args.probe == "breakdown":
        breakdown.run(args.device, nbytes=args.mb << 20, rounds=args.rounds, runs=args.runs)
    elif args.probe == "encode":
        encode.run(args.device, nbytes=args.mb << 20, row=args.row, runs=args.runs)
    elif args.probe == "select_batch":
        select_batch.run(args.device, nbytes=args.mb << 20, vocab=args.vocab, runs=args.runs)
    else:
        launch.run(args.device, calls=args.calls)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
