"""Structured metrics and profiling.

- MetricsLogger: JSON-lines event log (per-chunk loss/throughput/progress).
- Throughput: running steps/sec with the first interval excluded.
- profile_trace(): context manager around torch.profiler that writes a
  Chrome trace of the enclosed block (CPU and, when present, CUDA
  activity).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional


class MetricsLogger:
    """Append-only JSON-lines metrics sink."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a", buffering=1)

    def log(self, event: str, **fields):
        record = {"t": time.time(), "event": event, **fields}
        if self._fh:
            self._fh.write(json.dumps(record) + "\n")
        return record

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Throughput:
    """Running steps/sec, excluding the first (warm-up-bearing) interval."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._last = None
        self._steps = 0
        self._elapsed = 0.0
        self._intervals = 0

    def tick(self, steps_done: int) -> Optional[float]:
        now = time.time()
        if self._last is not None:
            dt = now - self._last[0]
            dsteps = steps_done - self._last[1]
            # a completion re-emit (early stop yields the final image again
            # at 100%) arrives moments after the real final chunk and may
            # carry the whole un-run remainder as phantom steps: no real
            # chunk completes in under a millisecond or runs >50x faster
            # than the running rate
            synthetic = dt < 1e-3 or (
                dsteps > 0 and self._elapsed > 0 and self._steps > 0
                and dsteps / dt > 50.0 * self._steps / self._elapsed)
            if synthetic:
                self._last = (now, steps_done)
                return self.steps_per_sec
            if self._intervals > 0:
                self._steps += dsteps
                self._elapsed += dt
            self._intervals += 1
        self._last = (now, steps_done)
        return self.steps_per_sec

    @property
    def steps_per_sec(self) -> Optional[float]:
        if self._elapsed <= 0:
            return None
        return self._steps / self._elapsed


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """torch.profiler trace of the enclosed block, exported as a Chrome
    trace into log_dir (no-op if log_dir is None)."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
