"""Structured metrics, spans and profiling.

- MetricsLogger: JSON-lines event log (per-chunk loss and progress).
- span(name, task=..., **attrs): one timed piece of the port's work at a
  layer boundary (a request's queue wait, a job's set-up, an L-BFGS
  step, a device->host read), with the span it runs inside and the task
  id(s) it serves. Start and end are ``time.time_ns()``, the clock
  ``torch.profiler`` stamps its events with, so a span and a device
  operation of a profiler trace compare directly.
- recorded_spans(): the spans kept so far, in a bounded in-memory buffer
  (the oldest go first once it is full).
- profile_trace(): context manager around torch.profiler that writes a
  Chrome trace of the enclosed block (CPU and, when present, CUDA
  activity) and, beside it, the spans recorded meanwhile.

On/off: a span is kept when a ``torch.profiler`` session runs (the
process-wide flag torch sets on profiler start and stop, which every
thread sees; ``profile_trace`` starts one) at its start or at its end: a
span open when a session starts keeps its true start, and one still open
when the session stops is kept too. Off, a span costs a clock read and a
flag read at each end, and setting the innermost-span variable; nothing
is stored.

Parents: a span's parent is the innermost span open in the same context
(a thread, or an asyncio task) when it is made, or the span passed as
``parent=``; a span with no ``task=`` serves its parent's task(s). A
span is made and timed from the ``span()`` call; ``with`` makes it the
innermost span while the block runs, and ``end()`` closes a span that
outlives a block (a request's ``online.job``).
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import itertools
import json
import os
import threading
import time
from typing import Deque, List, Optional

from torch.autograd import profiler as _profiler

_CAPACITY = 1 << 18                  # spans kept; the oldest go first
_SPANS: Deque["span"] = collections.deque(maxlen=_CAPACITY)
_IDS = itertools.count(1)
_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "astt_span", default=None)
_now = time.time_ns


class span:
    """A span named `name`, started now; see the module docstring. task:
    the task id, or a tuple of them, it serves (default: its parent's);
    parent: the span it runs inside where that is not the innermost open
    one (work handed to another thread); attrs: integer counters.

    A kept span holds name, task, id, parent (the parent's id or None),
    start_ns, end_ns, thread (the id of the thread that closed it) and
    attrs."""

    __slots__ = ("name", "task", "attrs", "id", "parent", "start_ns",
                 "end_ns", "thread", "_on", "_token")

    def __init__(self, name: str, task=None, parent: Optional["span"] = None,
                 **attrs):
        self.start_ns = _now()
        self._on = _profiler._is_profiler_enabled
        if parent is None:
            parent = _CURRENT.get()
        self.name = name
        if parent is None:
            self.task = task
            self.parent = None
        else:
            self.task = parent.task if task is None else task
            self.parent = parent.id
        self.attrs = attrs
        self.id = next(_IDS)
        self.end_ns = None

    def set(self, **attrs) -> None:
        """Add or replace integer counters (known once the work is done)."""
        self.attrs.update(attrs)

    def end(self) -> None:
        """Close the span (once; later calls do nothing) and keep it if
        spans were on at its start or are on now."""
        if self.end_ns is None:
            self.end_ns = _now()
            if self._on or _profiler._is_profiler_enabled:
                self.thread = threading.get_ident()
                _SPANS.append(self)

    def __enter__(self) -> "span":
        self._token = _CURRENT.set(self)
        return self

    def __exit__(self, *exc) -> None:
        _CURRENT.reset(self._token)
        self.end()

    def as_dict(self) -> dict:
        task = list(self.task) if isinstance(self.task, tuple) else self.task
        return {"name": self.name, "start_ns": self.start_ns,
                "end_ns": self.end_ns, "id": self.id, "parent": self.parent,
                "task": task, "thread": self.thread, **self.attrs}


def recorded_spans(since_ns: int = 0) -> List[span]:
    """The kept spans that ended at or after since_ns, oldest first."""
    return [s for s in list(_SPANS) if s.end_ns >= since_ns]


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


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """torch.profiler trace of the enclosed block, exported as a Chrome
    trace into log_dir/trace.json, and the spans recorded meanwhile as
    JSON lines (one 'span' event each, MetricsLogger's format, times on
    the trace's clock) into log_dir/spans.jsonl (no-op if log_dir is
    None)."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    t0 = time.time_ns()
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    path = os.path.join(log_dir, "spans.jsonl")
    if os.path.exists(path):
        os.remove(path)
    with MetricsLogger(path) as out:
        for s in recorded_spans(t0):
            out.log("span", **s.as_dict())
