"""The traced run's reading of the device: ``torch.profiler`` over bounded
slices of the window, kept as aggregates.

Each slice is one profiler session around a block that starts and ends
with the card synchronised, marked by a ``bench.slice`` range. From each
session the harness keeps, and then drops the events:

* the slice's wall time, from the marker;
* the device time and count of each device operation by name;
* the device's busy time: the union of the intervals in which a kernel, a
  fill or a copy within the card ran. A copy to or from the host is a
  transfer the host drives through its own memory, not work of the card,
  and the marker's own device-side range is no operation;
* the idle time between them, split by what the host thread was running
  then: the outermost operator under the marker, or ``host`` where it ran
  none.
"""

from __future__ import annotations

import bisect
import contextlib
from dataclasses import dataclass, field

MARKER = "bench.slice"
HOST = "host"


@dataclass
class Event:
    """One profiler event: host (``device=False``) or device, in ns."""

    name: str
    device: bool
    start: int
    end: int
    thread: int = 0


@dataclass
class Summary:
    """Aggregates over every slice of a run."""

    slices: int = 0
    window_s: float = 0.0
    busy_s: float = 0.0
    op_s: dict = field(default_factory=dict)
    op_count: dict = field(default_factory=dict)
    idle_s: dict = field(default_factory=dict)

    def kernel_s(self, name: str) -> float:
        """Device seconds of the operations whose name contains ``name``."""
        return sum(s for op, s in self.op_s.items() if name in op)

    def kernel_count(self) -> int:
        """Launches of device kernels, not copies or fills."""
        return sum(c for op, c in self.op_count.items() if not is_copy(op))

    def breakdown(self, top: int = 10) -> dict:
        def largest(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": largest(self.op_s), "idle_gaps": largest(self.idle_s)}


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def is_transfer(name: str) -> bool:
    return name.startswith(("Memcpy HtoD", "Memcpy DtoH"))


def union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def outermost(events: list[Event]) -> list[Event]:
    """The host events that no other given host event contains."""
    top: list[Event] = []
    for ev in sorted(events, key=lambda e: (e.start, -e.end)):
        if top and ev.end <= top[-1].end:
            continue
        top.append(ev)
    return top


def add_slice(summary: Summary, events: list[Event]) -> None:
    """Fold one session's events into ``summary``. The session's window
    is its ``bench.slice`` marker; a session without one adds nothing."""
    marks = [e for e in events if not e.device and e.name == MARKER]
    if not marks:
        return
    mark = marks[0]
    w0, w1 = mark.start, mark.end
    summary.slices += 1
    summary.window_s += (w1 - w0) / 1e9
    dev = [e for e in events
           if e.device and e.name != MARKER and e.end > w0 and e.start < w1]
    for e in dev:
        summary.op_s[e.name] = summary.op_s.get(e.name, 0.0) + (e.end - e.start) / 1e9
        summary.op_count[e.name] = summary.op_count.get(e.name, 0) + 1
    busy = union([(max(e.start, w0), min(e.end, w1)) for e in dev if not is_transfer(e.name)])
    summary.busy_s += sum(e - s for s, e in busy) / 1e9
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < w1:
        gaps.append((t, w1))
    host = outermost([e for e in events if not e.device and e.thread == mark.thread
                      and e is not mark and e.start >= w0 and e.end <= w1])
    starts = [h.start for h in host]
    for g0, g1 in gaps:
        covered = 0
        i = max(bisect.bisect_right(starts, g0) - 1, 0)
        while i < len(host) and host[i].start < g1:
            part = min(g1, host[i].end) - max(g0, host[i].start)
            if part > 0:
                summary.idle_s[host[i].name] = summary.idle_s.get(host[i].name, 0.0) + part / 1e9
                covered += part
            i += 1
        rest = max(g1 - g0 - covered, 0)
        summary.idle_s[HOST] = summary.idle_s.get(HOST, 0.0) + rest / 1e9


def profiler_events(prof) -> list[Event]:
    """The events of a stopped ``torch.profiler.profile``, read from its
    raw results without building its per-event Python objects."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if hasattr(e, "start_ns"):
            start, dur = e.start_ns(), e.duration_ns()
        else:
            start, dur = e.start_us() * 1000, e.duration_us() * 1000
        out.append(Event(e.name(), e.device_type().name != "CPU", start, start + dur,
                         e.start_thread_id()))
    return out


class Tracer:
    """Profiles the blocks it is given and keeps their aggregates."""

    def __init__(self, device):
        self.device = device
        self.summary = Summary()

    def warm(self):
        """Start and stop the profiler once, so that its first start, which
        takes seconds on a card, falls in the set-up."""
        with self.slice():
            pass
        self.summary = Summary()

    def _sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def slice(self):
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._sync()
        prof = profile(activities=activities)
        prof.start()
        try:
            with record_function(MARKER):
                yield
                self._sync()
        finally:
            prof.stop()
        add_slice(self.summary, profiler_events(prof))
        del prof
