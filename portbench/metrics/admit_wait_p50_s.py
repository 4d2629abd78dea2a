"""admit_wait_p50_s: the median queue wait of a request, in seconds: the
length of each of the program's ``online.queued`` spans (add_task until a
round or a live batch takes the task) that ends inside the traced
window. Read from the program's spans alone (held_idle_share.py)."""

from __future__ import annotations

import statistics
from typing import Optional

from portbench.metrics.held_idle_share import program_spans


def ended_in_window(trace, spans, name) -> list:
    """The lengths (s) of the spans named `name` that end in the window."""
    w0, w1 = trace.window_ns
    return [(s.end_ns - s.start_ns) / 1e9 for s in spans
            if s.name == name and w0 <= s.end_ns <= w1]


def median_of(trace, spans, name) -> Optional[float]:
    lengths = ended_in_window(trace, spans, name)
    return statistics.median(lengths) if lengths else None


def read(r):
    spans = program_spans()
    if r.trace is None or not spans:
        return None
    return median_of(r.trace, spans, "online.queued")
