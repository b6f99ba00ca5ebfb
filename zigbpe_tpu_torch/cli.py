"""Command-line interface of the PyTorch port: train / encode / decode /
gui / demo, with the same flags and output formats as ``zigbpe_tpu.cli``
plus ``--device`` (default ``cuda``). The tokenizer is built on
``--device`` only when the chosen backend reaches it; the host backends run
on the CPU, so they need no card. ``train --backend dp`` trains
data-parallel (``parallel/train_dp.py``); with ``--num-processes`` > 1 every
process joins one process group (``--coordinator host:port``,
``--process-id``, or the ``torchrun`` variables), reads only its byte range
of the corpus, and rank 0 writes ``--out``. ``encode``, ``gui`` and
``demo`` run ``dp`` as ``device``.

    python -m zigbpe_tpu_torch.cli demo --corpus taylorswift.txt
    python -m zigbpe_tpu_torch.cli train corpus.txt --backend dp --device cpu \
        --coordinator 127.0.0.1:29500 --num-processes 2 --process-id 0
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from .models.basic_tokenizer import _DEVICE_ENCODE_THRESHOLD, BasicTokenizer
from .utils import fileio

# main.zig:25 probe string, reproduced by `demo`
PROBE = "hello world!!!? (안녕하세요!) lol123 😉"


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--backend", choices=["auto", "device", "host", "oracle", "dp"], default="auto",
        help="device=PyTorch on --device, host=NumPy, oracle=pure Python, "
        "dp=data-parallel over a process group",
    )
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")


def _device(args, backend: str) -> str:
    """``--device`` when ``backend`` (auto already resolved) runs on it,
    else the CPU."""
    return args.device if backend in ("device", "dp") else "cpu"


def _train_multiprocess(args) -> int:
    """One process of a multi-process run: join the group, train on this
    rank's byte range, and on rank 0 write ``--out``."""
    from .parallel import multihost

    import torch.distributed as dist

    multihost.initialize(args.coordinator, args.num_processes, args.process_id,
                         device=args.device)
    tok = BasicTokenizer(device="cpu")
    t0 = time.time()
    try:
        tok.merges = multihost.train_from_files(
            args.corpus, args.vocab, device=args.device, chunk_rounds=args.chunk_rounds,
            verbose=args.verbose, checkpoint_dir=args.checkpoint_dir,
        )
        rank = multihost.process_info()[0]
    finally:
        dist.destroy_process_group()
    wall = time.time() - t0
    if rank == 0:
        tok.save_merges(args.out)
        print(f"trained {len(tok.merges)} merges in {wall * 1e3:.0f} ms -> {args.out}",
              file=sys.stderr)
    return 0


def cmd_train(args) -> int:
    nproc = args.num_processes or int(os.environ.get("WORLD_SIZE", "1"))
    if nproc > 1:
        return _train_multiprocess(args)
    data = fileio.read_corpus(args.corpus)
    backend = "device" if args.backend == "auto" else args.backend
    tok = BasicTokenizer(device=_device(args, backend))
    t0 = time.time()
    kwargs = {}
    if backend == "dp":
        from .parallel import train_dp as dp

        tok.merges = dp.train_dp(
            data, args.vocab, device=args.device, chunk_rounds=args.chunk_rounds,
            verbose=args.verbose, checkpoint_dir=args.checkpoint_dir,
        )
    else:
        if backend == "device":
            kwargs["chunk_rounds"] = args.chunk_rounds
            if args.checkpoint_dir:
                kwargs["checkpoint_dir"] = args.checkpoint_dir
            if args.time_stats_detailed:
                kwargs["detailed_stats"] = True
        tok.train(data, args.vocab, verbose=args.verbose, backend=backend, **kwargs)
    wall = time.time() - t0
    tok.save_merges(args.out)
    print(
        f"trained {len(tok.merges)} merges on {len(data)} bytes in {wall * 1e3:.0f} ms "
        f"({len(data) / max(wall, 1e-9) / 1e6:.1f} MB/s) -> {args.out}",
        file=sys.stderr,
    )
    if args.time_stats or args.time_stats_detailed:
        tok.time_stats.print_report()
    return 0


def cmd_encode(args) -> int:
    data = fileio.read_file(args.file) if args.file else args.text.encode("utf-8")
    backend = "device" if args.backend == "dp" else args.backend
    if backend == "auto":  # BasicTokenizer.encode's rule
        backend = "device" if len(data) >= _DEVICE_ENCODE_THRESHOLD else "host"
    tok = BasicTokenizer.from_merges_file(args.merges, device=_device(args, backend))
    ids = tok.encode(data, backend=backend)
    # main.zig:28-30 prints ids space-separated
    print(" ".join(str(i) for i in ids))
    return 0


def cmd_decode(args) -> int:
    tok = BasicTokenizer.from_merges_file(args.merges, device="cpu")
    if args.file:
        ids = [int(t) for t in fileio.read_file(args.file).split()]
    else:
        ids = [int(t) for t in args.ids.replace(",", " ").split()]
    sys.stdout.buffer.write(tok.decode(ids))
    sys.stdout.buffer.write(b"\n")
    return 0


def cmd_gui(args) -> int:
    """The interactive shell; ``auto`` encodes on the host, as the JAX
    package's shell does."""
    from .gui import app

    backend = {"auto": "host", "dp": "device"}.get(args.backend, args.backend)
    app.run(args.merges, backend=backend, device=_device(args, backend))
    return 0


def cmd_demo(args) -> int:
    """Reproduce the reference demo (main.zig:8-43): read corpus ->
    train(vocab) -> serialize merges -> encode probe -> decode -> timing."""
    data = fileio.read_file(args.corpus)
    backend = "device" if args.backend in ("auto", "dp") else args.backend
    tok = BasicTokenizer(device=_device(args, backend))
    t0 = time.time()
    tok.train(data, args.vocab, backend=backend)
    tok.save_merges(args.out)
    ids = tok.encode(PROBE)
    print(" ".join(str(i) for i in ids))
    print(tok.decode(ids).decode("utf-8"))
    print(f"Training completed in {(time.time() - t0) * 1e3:.0f} ms", file=sys.stderr)
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="zigbpe-torch", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train", help="train a merge table on a corpus")
    t.add_argument("corpus", nargs="+", help="corpus file(s), concatenated")
    t.add_argument("--vocab", type=int, default=300)
    t.add_argument("--out", default="merges.txt")
    t.add_argument("--verbose", action="store_true")
    t.add_argument("--chunk-rounds", type=int, default=64)
    t.add_argument("--time-stats", action="store_true")
    t.add_argument(
        "--time-stats-detailed", action="store_true",
        help="per-round sort/replace device-time split (reference "
        "TimeStats taxonomy; slower: syncs every round)",
    )
    t.add_argument("--checkpoint-dir", help="write/resume mid-training checkpoints here")
    # multi-process runs (torch.distributed); also settable via the torchrun
    # variables MASTER_ADDR / MASTER_PORT, WORLD_SIZE and RANK
    t.add_argument("--coordinator", help="host:port of rank 0 for multi-process runs")
    t.add_argument("--num-processes", type=int, help="total process count (multi-process)")
    t.add_argument("--process-id", type=int, help="this process's rank (multi-process)")
    _add_common(t)
    t.set_defaults(fn=cmd_train)

    e = sub.add_parser("encode", help="encode text/file to token ids")
    e.add_argument("--merges", required=True)
    g = e.add_mutually_exclusive_group(required=True)
    g.add_argument("--text")
    g.add_argument("--file")
    _add_common(e)
    e.set_defaults(fn=cmd_encode)

    d = sub.add_parser("decode", help="decode token ids to text")
    d.add_argument("--merges", required=True)
    g = d.add_mutually_exclusive_group(required=True)
    g.add_argument("--ids", help="ids, space- or comma-separated")
    g.add_argument("--file", help="file of whitespace-separated ids")
    d.set_defaults(fn=cmd_decode)

    g = sub.add_parser("gui", help="interactive tokenizer shell (reference GUI analogue)")
    g.add_argument("--merges", help="merge table; omitted = mirror-only (reference parity)")
    _add_common(g)
    g.set_defaults(fn=cmd_gui)

    m = sub.add_parser("demo", help="reference demo: train + probe round-trip")
    m.add_argument("--corpus", default="taylorswift.txt")
    m.add_argument("--vocab", type=int, default=300)
    m.add_argument("--out", default="merges.txt")
    _add_common(m)
    m.set_defaults(fn=cmd_demo)

    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
