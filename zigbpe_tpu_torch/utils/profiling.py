"""Profiling / time statistics — the reference's TimeStats analogue.

The reference threads a heap-allocated accumulator struct through every hot
function and prints per-phase totals, call counts, and averages plus a
derived "Other operations" bucket (utils/time_statistics.zig:4-60). The
report format mirrors the reference's taxonomy.

Device work is asynchronous: a phase that times device work passes its
device, and the phase then ends with ``torch.cuda.synchronize()`` when that
device is a CUDA device, so the recorded time includes the work it queued.

Beside the phases, which mirror the reference's, a ``span`` names a step
inside a phase and a counter (``count``) counts work done there. A span
never waits for the device: its time is the host's, waits the code makes
itself included. It also opens a function-scope profiler range of its
name, so a running ``torch.profiler`` (``trace`` below, or any other)
records it as a host event on its own clock; a function-scope range, unlike
``torch.profiler.record_function``, leaves no device-side annotation over
the kernels launched inside it.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional

import torch
from torch._C._profiler import _RecordFunctionFast


@dataclass
class _PhaseAcc:
    total_s: float = 0.0
    calls: int = 0


@dataclass
class _SpanAcc:
    total_s: float = 0.0
    self_s: float = 0.0  # the total less the child spans inside it
    calls: int = 0
    parent: Optional[str] = None  # the innermost open span or phase at its first call


@dataclass
class TimeStats:
    """Wall-clock phase accumulators (utils/time_statistics.zig:4-34)."""

    phases: Dict[str, _PhaseAcc] = field(default_factory=dict)
    _start: Optional[float] = None
    enabled: bool = True
    spans: Dict[str, _SpanAcc] = field(default_factory=dict)
    counters: Dict[str, int] = field(default_factory=dict)
    _open: List[list] = field(default_factory=list)  # open spans and phases, innermost last

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
        self._open.append([name, 0.0])
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if device is not None and torch.device(device).type == "cuda":
                torch.cuda.synchronize(device)
            self._open.pop()
            acc = self.phases.setdefault(name, _PhaseAcc())
            acc.total_s += time.perf_counter() - t0
            acc.calls += 1

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        """Time a step on the host clock, without waiting for the device,
        into ``spans[name]``, inside a profiler range of that name."""
        if not self.enabled:
            yield
            return
        frame = [name, 0.0]  # [name, seconds of the spans inside it]
        self._open.append(frame)
        t0 = time.perf_counter()
        try:
            with _RecordFunctionFast(name):
                yield
        finally:
            dt = time.perf_counter() - t0
            self._open.pop()
            parent = self._open[-1] if self._open else None
            if parent is not None:
                parent[1] += dt
            acc = self.spans.get(name)
            if acc is None:
                acc = self.spans[name] = _SpanAcc(parent=parent[0] if parent else None)
            acc.total_s += dt
            acc.self_s += dt - frame[1]
            acc.calls += 1

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to ``counters[name]``."""
        if self.enabled:
            self.counters[name] = self.counters.get(name, 0) + n

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
        if self.spans:
            lines.append("Spans (host clock, no device sync):")
            for name, acc in self.spans.items():
                lines.append(
                    f"  {name}: {acc.total_s * 1e3:.3f} ms total, {acc.self_s * 1e3:.3f} ms self, "
                    f"{acc.calls} calls, in {acc.parent or '-'}"
                )
        if self.counters:
            lines.append("Counters:")
            lines += [f"  {name}: {n}" for name, n in self.counters.items()]
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
