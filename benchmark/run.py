"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell, its configuration, its traffic mix
and its metrics are looked up by name in ``BENCHMARK.json``; the program
under test is the checkout's ``zigbpe_tpu_torch`` on the first CUDA card.
``--trace 0`` prints the cell's end-to-end metrics, ``--trace 1`` its
per-layer ones, read from profiled slices of the window. After the window
the check compares what the window produced with the plain reference in
``benchmark/reference/`` and prints each number compared beside its limit,
last on standard error and last in the result line.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and last ``compared``. Without a card, with fewer cards
than the cell needs, or with JAX or the JAX package loaded once the window
has closed, it prints no result and exits non-zero. So it does where the
window has not opened ``SETUP_LIMIT_S`` seconds after the process started,
the clock of ``setup_s``: it then prints the limit and the stack where
set-up stood, on standard error.
"""

from __future__ import annotations

import argparse
import faulthandler
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if sys.path and Path(sys.path[0]).resolve() == ROOT / "benchmark":
    sys.path[0] = str(ROOT)  # the harness's modules are imported as ``benchmark.*``
CACHE = ROOT / ".bench_cache"  # every compiler and kernel cache of a run, fixed in the checkout
FORBIDDEN = ("jax", "jaxlib", "flax", "zigbpe_tpu")
# Set-up that has not opened the window by then has stalled: on an H100 a
# first run, which builds every kernel, has taken up to 40 s, later ones 10-15 s.
SETUP_LIMIT_S = 180.0


def process_age_s() -> float | None:
    """Seconds since this process started, from ``/proc``; None where it
    cannot be read."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
    except (OSError, IndexError, ValueError):
        return None
    return uptime - ticks / os.sysconf("SC_CLK_TCK")


_T0 = time.perf_counter() - (process_age_s() or 0.0)


def limit_setup(limit_s: float = SETUP_LIMIT_S) -> None:
    """Ends the process with code 1 and no result where the window has not
    opened ``limit_s`` seconds after the process started (``_T0``):
    ``faulthandler``'s own thread, which needs no interpreter lock, prints
    ``Timeout`` and every thread's stack on standard error. A ``limited``
    ``run_cell`` cancels it as the window opens."""
    print(f"SETUP_LIMIT_S = {limit_s:g} s: a set-up still running then ends the run",
          file=sys.stderr, flush=True)
    faulthandler.dump_traceback_later(max(_T0 + limit_s - time.perf_counter(), 0.01), exit=True)


def forbidden_modules(modules=None, names=FORBIDDEN) -> list[str]:
    """The loaded modules whose top-level name, the part before the first
    dot, is one of ``names``, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in list(modules) if m.split(".", 1)[0] in names)


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else out.stderr.strip()


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool,
             device, program=None, limited: bool = False) -> dict:
    """One run of ``workload`` on ``device``: the result as a dict, in the
    result line's order. Checks no card; the command line does. ``program``
    puts another tokenizer class in ``BasicTokenizer``'s place; ``limited``
    cancels the set-up limit as the window opens."""
    import torch

    from benchmark import loops, spec
    from benchmark.record import Run
    from benchmark.trace import Tracer

    bench = spec.load(root)
    cell = spec.cell(bench, workload)
    run = Run(cell, spec.config(root, bench, cell["config"]), spec.traffic(root, cell["traffic"]),
              torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu")
    tracer = Tracer(device) if trace else None
    if tracer:
        tracer.warm()

    def ready() -> float:
        now = time.perf_counter()
        run.setup_s = now - _T0
        if limited:
            faulthandler.cancel_dump_traceback_later()
        return now

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    check = loops.KINDS[run.traffic["kind"]](
        run, loops.Context(root, seed, seconds, device, tracer, ready, program))
    run.trace = tracer.summary if tracer else None
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checked = check()

    metrics = {}
    for m in spec.metrics(bench, workload, trace):
        value = spec.reader(root, m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": run.device_kind,
           "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": checked.correct, "attempted": len(run.jobs) + len(run.calls),
              "failed": checked.failed, "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    if run.calls:
        ms = sorted(c.seconds * 1e3 for c in run.calls)
        checked.notes = {"calls": len(ms), "call_median_ms": ms[len(ms) // 2], **checked.notes}
    result["notes"] = checked.notes
    result["compared"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checked.numbers.items()}
    return result


def main(argv=None) -> int:
    limit_setup()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(CACHE / sub)
    import torch

    from benchmark import spec

    import zigbpe_tpu_torch

    if not Path(zigbpe_tpu_torch.__file__).resolve().is_relative_to(ROOT):
        print(f"zigbpe_tpu_torch loaded from {zigbpe_tpu_torch.__file__}, outside {ROOT}",
              file=sys.stderr)
        return 2
    chips = spec.cell(spec.load(ROOT), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {chips} CUDA card(s); this machine has {n}",
              file=sys.stderr)
        return 2
    print(card_line(), file=sys.stderr)
    return report(run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                           torch.device("cuda", 0), limited=True))


def report(result: dict) -> int:
    """Print ``result`` as a run ends: its numbers on standard error, then
    the result line; nothing, and a non-zero code, where JAX or the JAX
    package has been loaded."""
    loaded = forbidden_modules()
    if loaded:
        print(f"loaded after the window: {', '.join(loaded)}", file=sys.stderr)
        return 3
    for name, m in result["metrics"].items():
        print(f"{name} {m['value']} {m['unit']}", file=sys.stderr)
    for name, v in result["notes"].items():
        print(f"{name} {v}", file=sys.stderr)
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
