"""Profiling / time statistics — the reference's TimeStats analogue.

The reference threads a heap-allocated accumulator struct through every hot
function and prints per-phase totals, call counts, and averages plus a
derived "Other operations" bucket (utils/time_statistics.zig:4-60). The
report format mirrors the reference's taxonomy.

Device work is asynchronous: a phase that times device work passes its
device, and the phase then ends with ``torch.cuda.synchronize()`` when that
device is a CUDA device, so the recorded time includes the work it queued.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, Optional

import torch


@dataclass
class _PhaseAcc:
    total_s: float = 0.0
    calls: int = 0


@dataclass
class TimeStats:
    """Wall-clock phase accumulators (utils/time_statistics.zig:4-34)."""

    phases: Dict[str, _PhaseAcc] = field(default_factory=dict)
    _start: Optional[float] = None
    enabled: bool = True

    @classmethod
    def null(cls) -> "TimeStats":
        return cls(enabled=False)

    def start(self) -> None:
        self._start = time.perf_counter()

    @contextlib.contextmanager
    def phase(self, name: str, device=None) -> Iterator[None]:
        """Time a block. With a CUDA ``device``, the block's queued device
        work is waited for before the clock stops."""
        if not self.enabled:
            yield
            return
        if self._start is None:
            self.start()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if device is not None and torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
            acc = self.phases.setdefault(name, _PhaseAcc())
            acc.total_s += time.perf_counter() - t0
            acc.calls += 1

    def report(self) -> str:
        """Render the phase report (utils/time_statistics.zig:36-60 format
        family: per-phase total/calls/average + derived Other bucket)."""
        total = (time.perf_counter() - self._start) if self._start is not None else sum(
            a.total_s for a in self.phases.values()
        )
        lines = ["Time statistics:"]
        accounted = 0.0
        for name, acc in self.phases.items():
            avg_ms = (acc.total_s / acc.calls * 1e3) if acc.calls else 0.0
            lines.append(
                f"  {name}: {acc.total_s * 1e3:.3f} ms total, "
                f"{acc.calls} calls, {avg_ms:.3f} ms avg"
            )
            accounted += acc.total_s
        lines.append(f"  Other operations: {max(total - accounted, 0.0) * 1e3:.3f} ms")
        lines.append(f"  Total: {total * 1e3:.3f} ms")
        return "\n".join(lines)

    def print_report(self) -> None:
        print(self.report())


@contextlib.contextmanager
def trace(log_dir: str | os.PathLike) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of a block (CPU activity and, when
    a card is present, CUDA activity) and write it into ``log_dir`` as a
    Chrome/TensorBoard ``*.pt.trace.json`` file."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(log_dir))):
        yield
