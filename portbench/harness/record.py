"""What a run saw, on the host's clock, and the arithmetic over it.

Every time is ``time.perf_counter()`` of this process. A job's record
holds when it was due, when it was handed to the program, and each
progress report the program delivered (time, steps done, loss if the
entry reports one, image if the check needs it). Rates and percentiles
are taken over every sample in the window, never over per-chunk
summaries.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np


def now() -> float:
    return time.perf_counter()


class Recorder:
    """The ``metrics=`` object the program's executors log to (the
    ``MetricsLogger`` interface: ``log(event, **fields)``), kept in
    memory with this process's clock."""

    def __init__(self):
        self.events: List[dict] = []
        self._lock = threading.Lock()

    def log(self, event: str, **fields):
        record = {"t": now(), "event": event, **fields}
        with self._lock:
            self.events.append(record)
        return record

    def of(self, event: str) -> List[dict]:
        with self._lock:
            return [e for e in self.events if e["event"] == event]


@dataclasses.dataclass
class Report:
    t: float
    done: int                       # optimizer steps completed
    loss: Optional[float] = None
    image: Optional[np.ndarray] = None  # [0, 1] HWC, where delivered


@dataclasses.dataclass
class Job:
    tid: str
    index: int                      # its place in the traffic
    content: np.ndarray
    style: np.ndarray
    noise_seed: int                 # the seed of its initial image's noise
    due: Optional[float] = None     # when the traffic meant to send it
    added: Optional[float] = None   # when it was handed to the program
    reports: List[Report] = dataclasses.field(default_factory=list)

    def first(self) -> Optional[Report]:
        return self.reports[0] if self.reports else None


@dataclasses.dataclass
class RunRecord:
    """What an entry hands back to the harness."""

    jobs: Dict[str, Job]
    t_start: float                  # process start
    t_open: float
    t_close: float
    peak_setup_bytes: int           # max_memory_allocated before the window
    peak_window_bytes: int          # max_memory_allocated in the window
    launches_window: Dict[str, int]
    traced: bool = False            # a profiler recorded the window
    checked: List[str] = dataclasses.field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    notes: Dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return self.t_close - self.t_open

    def steps_between(self, t0: float, t1: float) -> int:
        """Job-steps the reports in (t0, t1] add, each report counting the
        steps since its job's previous one."""
        total = 0
        for job in self.jobs.values():
            prev = 0
            for rep in job.reports:
                if t0 < rep.t <= t1:
                    total += rep.done - prev
                prev = rep.done
        return total

    def due_in_window(self) -> List[Job]:
        return [j for j in self.jobs.values()
                if j.due is not None and self.t_open <= j.due < self.t_close]


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The q-th percentile (0-100) of all the values, linear between
    order statistics; None for no values."""
    if not len(values):
        return None
    return float(np.percentile(np.asarray(values, np.float64), q))


def delta(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    return {k: after.get(k, 0) - before.get(k, 0) for k in after}
