"""What one run of a cell leaves for the metric readers."""

from __future__ import annotations

from dataclasses import dataclass, field

from benchmark.trace import Summary


@dataclass
class Job:
    """One whole training job in the window."""

    nbytes: int
    seconds: float
    merges: int
    phases: dict  # TimeStats phase -> (seconds, calls)
    traced: bool = False
    counters: dict = field(default_factory=dict)  # the program's counters at the job's end


@dataclass
class Call:
    """One call of an encode entry in the window."""

    nbytes: int
    docs: int
    ids: int
    seconds: float
    traced: bool = False
    counters: dict = field(default_factory=dict)  # what the call added to the program's counters


@dataclass
class Run:
    cell: dict
    config: dict
    traffic: dict
    device_kind: str = "cpu"  # torch.cuda.get_device_name, or cpu
    setup_s: float | None = None
    window_s: float = 0.0
    jobs: list = field(default_factory=list)
    calls: list = field(default_factory=list)
    trace: Summary | None = None
    traced_merges: int = 0  # merges made inside the traced slices, as the trainer printed them

    def untraced_jobs(self) -> list:
        """The jobs no profiler slowed, or all jobs where every one was traced."""
        return [j for j in self.jobs if not j.traced] or self.jobs

    def traced_calls(self) -> list:
        return [c for c in self.calls if c.traced]
