"""The measured window, shared by every entry.

An entry calls ``open()`` when set-up is over and ``close()`` when the
window's seconds have passed. Opening reads the set-up's memory peak and
resets it, and snapshots the program's kernel-launch counters; a traced
run's profiler starts just before the opening and stops just after the
close. The peaks are ``max_memory_allocated``: what the program's
tensors held at most. A captured CUDA graph's activations are allocated
while it is captured, in set-up, so the set-up's peak holds them; the
allocator's reserved peak, which also keeps the cache of blocks no
tensor holds, is kept as a note.
"""

from __future__ import annotations

from typing import Dict, Optional

from .record import Job, RunRecord, delta, now
from .trace import Tracer

class WindowClosed(BaseException):
    """Raised from the benchmark's own progress hook once the window has
    closed and the check has what it needs: it ends the program's run at
    its next delivery (a BaseException, so that the program's per-job
    isolation, which catches Exception, lets it through)."""


class Session:
    def __init__(self, seconds: float, trace: bool, t_start: float):
        self.seconds = float(seconds)
        self.t_start = t_start
        self.tracer: Optional[Tracer] = Tracer() if trace else None
        self.t_open: Optional[float] = None
        self.t_close: Optional[float] = None
        self._counts: Dict[str, Dict[str, int]] = {}
        self.peak_setup = self.peak_window = 0
        self.reserved = {}

    @staticmethod
    def _launches() -> Dict[str, int]:
        from artstyletransfer_tpu_torch import kernels

        return dict(kernels.LAUNCHES)

    @staticmethod
    def _cuda():
        import torch

        return torch.cuda if torch.cuda.is_available() else None

    def open(self) -> float:
        cuda = self._cuda()
        if cuda is not None:
            self.peak_setup = cuda.max_memory_allocated()
            self.reserved["setup"] = cuda.max_memory_reserved()
            cuda.reset_peak_memory_stats()
        if self.tracer is not None:
            self.tracer.start()  # slow at first use: before the opening
        self._counts["open"] = self._launches()
        self.t_open = (self.tracer.open() if self.tracer is not None
                       else now())
        return self.t_open

    def due(self, t: Optional[float] = None) -> bool:
        """Whether the window's seconds have passed at t (now)."""
        return (self.t_open is not None
                and (now() if t is None else t) - self.t_open >= self.seconds)

    def close(self) -> float:
        self.t_close = (self.tracer.close() if self.tracer is not None
                        else now())
        self._counts["close"] = self._launches()
        if self.tracer is not None:
            self.tracer.finish()
        cuda = self._cuda()
        if cuda is not None:
            self.peak_window = cuda.max_memory_allocated()
            self.reserved["window"] = cuda.max_memory_reserved()
        return self.t_close

    def record(self, jobs: Dict[str, Job], notes=None, **kw) -> RunRecord:
        c = self._counts
        notes = dict(notes or {})
        if self.reserved:
            notes["reserved_peak_bytes"] = self.reserved
        return RunRecord(
            jobs=jobs, t_start=self.t_start, t_open=self.t_open,
            t_close=self.t_close, peak_setup_bytes=self.peak_setup,
            peak_window_bytes=self.peak_window,
            launches_window=delta(c["close"], c["open"]),
            traced=self.tracer is not None, notes=notes, **kw)
