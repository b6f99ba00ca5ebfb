"""Measurement probes of the merge pass: how a pass spends its time on the
card.

    python -m zigbpe_tpu_torch.probes [--device cuda] [--runs 5]
        budget|floor|pipeline|alu16|hist|lowering|launch|seed|breakdown|encode|select_batch

Ports of the TPU measurement scripts, each on its own kernels:
- ``budget`` (``scripts/probe_merge_budget.py``): the merge pass with one
  piece switched off at a time (``merge_pass_ablated``), replayed over the
  first NP passes of a real training run; the differences are the pieces'
  costs, and ``torch.profiler`` gives the device time of ``full``'s one
  launch;
- ``floor`` (``scripts/probe_floor.py``): the blocked copy
  (``copy_blocks``) against block size and dtype, the streaming floor;
- ``pipeline`` (``scripts/probe_pipeline.py``): copies shaped like the merge
  pass's grid (``copy_carry``, ``copy_peek``) against the production pass;
- ``alu16`` (``scripts/probe_alu16.py``): the merge kernel's op mix
  (``opmix``) in int32 against packed int16;
- ``hist`` (``scripts/probe_hist.py``): the blocked copy with two masked
  histograms kept exact in the pass (``onehot_hist``), against the plain
  copy;
- ``lowering`` (``scripts/probe_mosaic_ops.py``): each construct the TPU
  build checked (``ops.kernels.lowering``), held against its twin.
- ``launch``: where a kernel wrapper's host time goes, piece by piece, and
  each wrapper's whole call (card only).
- ``seed``: the trainer's two seeds of its upper-bound table (counted on
  the host by the native runtime and placed, or counted on the device),
  and the native and Python whole-file reads, in turns; host work, so on
  the host clock with the device synchronised at the end of each run.
- ``breakdown`` (``scripts/profile_breakdown.py``): a training chunk split
  into its merge passes (``replay``), its selection (``select``, the merge
  stubbed) and the rest;
- ``encode`` (``scripts/probe_encode.py``): the encode kernel over the
  corpus in rows under a ``group_merges`` table;
- ``select_batch`` (``scripts/ab_select_batch.py``): training with the
  verify batch at 8, 16 and 32, the merges required equal.

On a CUDA device every row is timed with CUDA events: one warm-up run, then
the median of ``runs`` runs with their range. On the CPU the probes run the
plain twins at whatever size they are given, on the host clock, and report
no device metric.
"""

from __future__ import annotations

import statistics
import subprocess
import time

import torch

# One NVIDIA H100 SXM's HBM3 bandwidth and dense bf16 tensor-core rate
# (NVIDIA data sheet), at a 700 W limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
# Per clock on each of its 132 SMs: 64 INT32 lanes and 128 bytes of shared
# memory (Hopper architecture white paper).
SMS = 132
INT32_LANES_PER_SM = 64
SMEM_BYTES_PER_CLOCK_SM = 128


def max_sm_clock_hz(index: int = 0) -> float:
    """The card's maximum SM clock, as ``nvidia-smi`` reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.split()
    return float(out[index]) * 1e6


def int32_bound_ms(ops: float, clock_hz: float) -> float:
    """The least time for ``ops`` INT32 instructions a thread (one lane's
    operation each) on every INT32 lane of the card at ``clock_hz``."""
    return ops / (SMS * INT32_LANES_PER_SM * clock_hz) * 1e3


def smem_bound_ms(nbytes: float, clock_hz: float) -> float:
    """The least time to move ``nbytes`` through the SMs' shared memory at
    ``clock_hz``."""
    return nbytes / (SMS * SMEM_BYTES_PER_CLOCK_SM * clock_hz) * 1e3


def bound_ms(nbytes: float, flops: float = 0.0) -> tuple[float, str]:
    """The least time the card could take for work that moves ``nbytes``
    and does ``flops`` bf16 tensor-core operations, and which of the two
    sets it: (ms, "bytes" or "operations")."""
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_BF16_FLOPS * 1e3
    return (by_ops, "operations") if by_ops > by_bytes else (by_bytes, "bytes")


def device_line(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them, or
    a note that a CPU run measures the host."""
    if device.type != "cuda":
        return f"device {device}: plain PyTorch twins on the host clock, no device metric"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[device.index or 0]


def time_runs(fn, device: torch.device, runs: int, setup=None) -> list[float]:
    """Milliseconds of ``fn()`` in each of ``runs`` runs after one warm-up.
    ``setup()``, when given, runs before each run and outside its span.
    CUDA events on a CUDA device; the host clock on the CPU."""
    if runs < 1:
        raise ValueError(f"runs must be >= 1, got {runs}")
    times = []
    for i in range(runs + 1):
        if setup is not None:
            setup()
        if device.type == "cuda":
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            ms = e0.elapsed_time(e1)
        else:
            t0 = time.perf_counter()
            fn()
            ms = (time.perf_counter() - t0) * 1e3
        if i:
            times.append(ms)
    return times


def spread(times: list[float], per: int = 1) -> tuple[float, float, float]:
    """(median, min, max) of ``times``, each divided by ``per``."""
    return statistics.median(times) / per, min(times) / per, max(times) / per
