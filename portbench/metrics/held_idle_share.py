"""held_idle_share: the device's idle share while the program holds a
job: device-idle time (the traced window less the union of the device's
operations) inside the union of the program's ``online.job`` spans (a
request from add_task to its final image or failure), over that union's
length, both cut to the traced window, as a share.

The spans are the program's own (``utils/metrics.py``: kept while a
profiler session runs, on the profiler's clock); a program that records
none reads nothing. The interval arithmetic here serves the other span
readers too."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

Interval = Tuple[int, int]


def program_spans() -> Optional[list]:
    """The spans the program kept (objects with name, start_ns, end_ns),
    or None for a program that keeps none."""
    try:
        from artstyletransfer_tpu_torch.utils.metrics import recorded_spans
    except ImportError:
        return None
    return recorded_spans()


def union(intervals: Sequence[Interval]) -> List[Interval]:
    """Sorted, disjoint intervals covering the same time as `intervals`."""
    merged: List[List[int]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def length(intervals: Sequence[Interval]) -> int:
    return sum(e - s for s, e in intervals)


def overlap(a: Sequence[Interval], b: Sequence[Interval]) -> int:
    """Time two sorted, disjoint interval lists share."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle(trace) -> List[Interval]:
    """The window's device-idle intervals: its complement of the device's
    busy intervals."""
    w0, w1 = trace.window_ns
    out, t = [], w0
    for s, e in trace.busy_intervals():
        if s > t:
            out.append((t, min(s, w1)))
        t = max(t, e)
    if t < w1:
        out.append((t, w1))
    return [(s, e) for s, e in out if e > s]


def covered(trace, spans, match) -> List[Interval]:
    """The union of the spans whose name `match` accepts, cut to the
    traced window."""
    w0, w1 = trace.window_ns
    return union([(max(s.start_ns, w0), min(s.end_ns, w1)) for s in spans
                  if match(s.name) and s.end_ns > w0 and s.start_ns < w1])


def share(trace, spans) -> Optional[float]:
    held = covered(trace, spans, lambda name: name == "online.job")
    if not held:
        return None
    return 100.0 * overlap(idle(trace), held) / length(held)


def read(r):
    spans = program_spans()
    if r.trace is None or not spans:
        return None
    return share(r.trace, spans)
