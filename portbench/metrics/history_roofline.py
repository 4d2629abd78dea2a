"""history_roofline: the L-BFGS history work's share of its roofline: the
least bytes (yardstick/history.py) of each of the program's
``lbfgs.history`` spans that lies in the traced window and carries its
pairs, at 3.35 TB/s, over the device time of the operations those spans
launched. The spans mark the host's launch of the card step's accept
graph; an operation is the span's when its correlation id is that of a
runtime call made inside the span (a graph's kernels carry the id of its
launch). A program without the span, or a run without a trace, reads
nothing."""

from __future__ import annotations

import bisect
from typing import Optional

from portbench.harness.trace import HOST_LAUNCH_CALLS, MARK
from portbench.metrics.held_idle_share import program_spans
from portbench.yardstick.history import history_bytes, row_bytes

SPAN = "lbfgs.history"


def share(spans, launches, device, window, row: int,
          bytes_per_s: float) -> Optional[float]:
    """spans: the program's spans; launches: (start_ns, correlation id) of
    the runtime calls that launched work; device: (start_ns, end_ns,
    correlation id) of the device's operations; window: (start_ns,
    end_ns)."""
    w0, w1 = window
    history = [s for s in spans if s.name == SPAN and "pairs" in s.attrs
               and w0 <= s.start_ns and s.end_ns <= w1]
    if not history:
        return None
    launches = sorted(launches)
    starts = [t for t, _c in launches]
    ids, nbytes = set(), 0.0
    for s in history:
        lo = bisect.bisect_left(starts, s.start_ns)
        hi = bisect.bisect_right(starts, s.end_ns)
        if lo == hi:
            continue
        ids.update(c for _t, c in launches[lo:hi])
        a = s.attrs
        nbytes += history_bytes(a["lanes"], a["pairs"], a["n"], row)
    secs = sum(e - s for s, e, c in device if c in ids) / 1e9
    if not secs:
        return None
    return 100.0 * nbytes / bytes_per_s / secs


def _tracer(record):
    """The benchmark's profiler session of this run: the Tracer whose
    window is the record's."""
    import gc

    from portbench.harness.trace import Tracer

    for obj in gc.get_objects():
        if (type(obj) is Tracer and obj.prof is not None
                and obj.host == (record.t_open, record.t_close)):
            return obj
    return None


def events(tracer):
    """(launches, device operations) of a finished session, as share()
    takes them."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    launches, device = [], []
    for evt in tracer.prof.profiler.kineto_results.events():
        name = evt.name()
        if evt.device_type() == cuda:
            if MARK not in name:
                start = int(evt.start_ns())
                device.append((start, start + int(evt.duration_ns()),
                               int(evt.correlation_id())))
        elif name.startswith(HOST_LAUNCH_CALLS):
            launches.append((int(evt.start_ns()), int(evt.correlation_id())))
    return launches, device


def read(r):
    spans = program_spans()
    if r.trace is None or not spans:
        return None
    tracer = _tracer(r.record)
    if tracer is None:
        return None
    launches, device = events(tracer)
    return share(spans, launches, device, r.trace.window_ns,
                 row_bytes(r.fields), r.bytes_per_s)
