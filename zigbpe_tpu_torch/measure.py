"""What the measurement entry points share: the host clock, the result
line's fields, the encode table of the serving path and its replay over
rows.

Used by the headline benchmark (``zigbpe_tpu_torch.bench``), the
configuration runs (``scripts.run_config2``, ``scripts.run_config3``) and the
probes ``breakdown``, ``encode``, ``select_batch`` and ``seed``.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import torch

from .native import fastio
from .ops import core
from .ops.kernels import encode as ke
from .probes import device_line

RESULTS_DIR = Path(__file__).resolve().parents[1] / "results"
# the serving path's table and rows, as bench.py and run_config3.py fix them
ENCODE_ROW = 32768
ENCODE_MERGES = 1024
ENCODE_TABLE_BYTES = 1 << 20


def host_ms(fn, device: torch.device):
    """(result, ms) of ``fn()`` on the host clock. On a CUDA device the
    device is synchronised before the clock starts, so earlier work never
    counts, and again before it stops."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, (time.perf_counter() - t0) * 1e3


def host_runs(fn, device: torch.device, runs: int) -> list[float]:
    """ms of each of ``runs`` runs of ``fn()`` on the host clock, after one
    warm-up run."""
    return [host_ms(fn, device)[1] for _ in range(runs + 1)][1:]


def device_field(device: torch.device) -> str:
    """The ``device`` of a result line: the card's name and power limit as
    ``nvidia-smi`` reports them, or ``cpu``."""
    return device_line(device) if device.type == "cuda" else "cpu"


def card_value(device: torch.device, value, digits: int):
    """``value`` (a number or a list of numbers) rounded to ``digits``, or
    None off the card: a host-clock time of the plain twins is no card
    metric."""
    if device.type != "cuda":
        return None
    if isinstance(value, list):
        return [round(v, digits) for v in value]
    return round(value, digits)


def size_label(nbytes: int) -> str:
    """A corpus size in MiB as a metric name writes it: ``32`` for 32 MiB,
    ``0.0625`` for 64 KiB."""
    return f"{nbytes / (1 << 20):g}"


def write_result(name: str, result: dict) -> Path:
    """Write ``result`` as one JSON line to ``RESULTS_DIR/<name>.json``."""
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    path = RESULTS_DIR / f"{name}.json"
    path.write_text(json.dumps(result) + "\n")
    return path


def native_table(data: bytes) -> np.ndarray:
    """[ENCODE_MERGES, 3] int32: the merges the native trainer finds on the
    first ENCODE_TABLE_BYTES of ``data``."""
    table = fastio.train(data[:ENCODE_TABLE_BYTES], 256 + ENCODE_MERGES)
    return np.asarray(table, np.int32).reshape(-1, 3)


def scheduled_table(data: bytes, device: torch.device):
    """(gtable, glens) on ``device``: ``native_table(data)`` scheduled into
    fused passes of cap 32, as bench.py and run_config3.py do."""
    gt, gl = ke.schedule_merges(native_table(data), cap=32)
    return torch.from_numpy(gt).to(device), torch.from_numpy(gl).to(device)


def stage_rows(data: bytes, row: int, device: torch.device):
    """(rows, ms): the whole ``row``-token rows of ``data`` staged by
    ``core.pad_tokens`` (the bytes cross as uint8 and widen on the device)
    and viewed as [B, row] with no second copy, and the staging's ms on the
    host clock."""
    n = len(data) // row * row
    (tokens, _), ms = host_ms(lambda: core.pad_tokens(data[:n], n, device), device)
    return tokens.view(-1, row), ms


def replay_rows(rows: torch.Tensor, gt: torch.Tensor, gl: torch.Tensor, timed):
    """(MB/s of each timed run, tokens out): ``encode_rows_grouped`` replays
    the table over ``rows`` under ``timed(fn)``, which runs ``fn`` (its
    warm-up included) and returns each timed run's ms. Each run's output is
    freed as it ends; only the lengths of the last are kept."""
    last = {}

    def replay():
        last["lens"] = ke.encode_rows_grouped(rows, gt, gl)[1]

    mbps = [rows.numel() / (ms / 1e3) / 1e6 for ms in timed(replay)]
    return mbps, int(last["lens"].sum(dtype=torch.int64))
