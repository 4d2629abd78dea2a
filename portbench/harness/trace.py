"""The benchmark's own ``torch.profiler`` session and what it reads.

A traced run profiles its whole window (see Tracer). From the raw
events: every device operation's interval (kernels, copies,
sets), their union (busy time), the idle gaps and the host operation
that overlapped each, the device time by operation name, and the host
runtime calls that launched work (a graph launch counts once; the
arithmetic of ``scripts/profile_torch_step.py``, with idle taken over the
whole traced window instead of first kernel to last).
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

from .record import now

# runtime calls that launch work from the host: a kernel, a cluster
# launch, or a whole CUDA graph (one call, however many kernels)
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel",
                     "cudaLaunchCooperativeKernel", "cudaGraphLaunch",
                     "cuGraphLaunch")
MARK = "spin_kernel"  # torch.cuda._sleep's kernel: the window's markers
MARK_CYCLES = 1000


def _times_ns(evt) -> Tuple[int, int]:
    if hasattr(evt, "start_ns"):
        start = int(evt.start_ns())
        return start, start + int(evt.duration_ns())
    start = int(evt.start_us() * 1000)
    return start, start + int(evt.duration_us() * 1000)


@dataclasses.dataclass
class TraceData:
    window_ns: Tuple[int, int]
    device: List[Tuple[int, int, str]]   # device ops, clipped to the window
    host: List[Tuple[int, int, str]]     # host ops and runtime calls
    host_launches: int
    runtime_calls: int

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        merged: List[List[int]] = []
        for s, e, _ in sorted(self.device):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def device_seconds(self, match) -> Tuple[float, int]:
        """(seconds, count) of the device ops whose name `match` accepts."""
        secs, count = 0, 0
        for s, e, name in self.device:
            if match(name):
                secs += e - s
                count += 1
        return secs / 1e9, count

    def top_device_ops(self, n: int = 10) -> List[list]:
        total: Dict[str, int] = defaultdict(int)
        for s, e, name in self.device:
            total[name] += e - s
        top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:200], ns / 1e9] for name, ns in top]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The n longest device-idle gaps in the window, each named by the
        innermost host operation overlapping its middle."""
        w0, w1 = self.window_ns
        edges = [w0]
        for s, e in self.busy_intervals():
            edges += [s, e]
        edges.append(w1)
        gaps = [(b - a, a, b) for a, b in zip(edges[::2], edges[1::2])
                if b > a]
        gaps.sort(reverse=True)
        if self.host:
            hs = np.array([h[0] for h in self.host], np.int64)
            he = np.array([h[1] for h in self.host], np.int64)
        out = []
        for length, a, b in gaps[:n]:
            name = "host: no op recorded"
            if self.host:
                mid = (a + b) // 2
                inside = np.flatnonzero((hs <= mid) & (he >= mid))
                if inside.size:
                    best = inside[np.argmin(he[inside] - hs[inside])]
                    name = "host: " + self.host[best][2][:190]
            out.append([name, length / 1e9])
        return out


class Tracer:
    """One profiler session over the whole window: CUDA activity (device
    operations, and the host's runtime calls), no host operator events,
    so that it costs the program little. Two marker kernels
    (``torch.cuda._sleep``'s ``spin_kernel``) launched at the opening
    and at the close mark the window on the profiler's clock; the
    profiler starts before the opening and stops after the close, since
    both are slow."""

    def __init__(self):
        self.prof = None
        self.host = None  # (opening, close) on the host's clock
        self._finished = False

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                else [ProfilerActivity.CPU])
        self.prof = profile(activities=acts)
        self.prof.start()

    @staticmethod
    def _mark() -> float:
        import torch

        if torch.cuda.is_available():
            torch.cuda._sleep(MARK_CYCLES)
        return now()

    def open(self) -> float:
        self.host = (self._mark(), None)
        return self.host[0]

    def close(self) -> float:
        self.host = (self.host[0], self._mark())
        return self.host[1]

    def finish(self) -> None:
        import torch

        if self.prof is not None and not self._finished:
            self._finished = True
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.prof.stop()

    def parse(self) -> TraceData:
        import torch

        self.finish()
        cuda = torch.autograd.DeviceType.CUDA
        marks: List[int] = []
        device, host = [], []
        for evt in self.prof.profiler.kineto_results.events():
            name = evt.name()
            s, e = _times_ns(evt)
            if evt.device_type() == cuda:
                if MARK in name:
                    marks.append(s)
                elif not getattr(evt, "is_user_annotation",
                                 lambda: False)():
                    device.append((s, e, name))
                continue
            host.append((s, e, name))
        if len(marks) >= 2:
            w0, w1 = min(marks), max(marks)
        else:  # no card: the span of what was recorded
            everything = [t for d in device + host for t in d[:2]]
            w0, w1 = min(everything, default=0), max(everything, default=0)
        device = [(max(s, w0), min(e, w1), n) for s, e, n in device
                  if e > w0 and s < w1]
        host_in = [h for h in host if h[1] > w0 and h[0] < w1]
        launches = sum(1 for _s, _e, n in host_in
                       if n.startswith(HOST_LAUNCH_CALLS))
        calls = sum(1 for _s, _e, n in host_in
                    if n.startswith(("cuda", "cu")))
        # the markers' own launches
        launches -= min(launches, len(marks))
        return TraceData(window_ns=(w0, w1), device=device, host=host_in,
                         host_launches=launches, runtime_calls=calls)


def optional_parse(tracer: Optional[Tracer]) -> Optional[TraceData]:
    return tracer.parse() if tracer is not None and tracer.prof else None
