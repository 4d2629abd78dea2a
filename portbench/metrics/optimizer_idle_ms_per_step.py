"""optimizer_idle_ms_per_step: device-idle milliseconds inside the
program's L-BFGS spans (any ``lbfgs.*`` span: a step, its direction, its
line search, a blocking device->host read; their union, so each instant
counts once) and outside the spans they call into (a span below an
``lbfgs.*`` span that is not one itself: the engine's evaluations, a
graph capture), cut to the traced window, per job-step completed in the
window (the reports' steps, as served_steps_per_s counts them). An
evaluation's own idle (its copy-in and launch) is the engine's, not the
optimizer's."""

from __future__ import annotations

from typing import Optional

from portbench.metrics.held_idle_share import (covered, idle, overlap,
                                               program_spans)


def _optimizer(name: str) -> bool:
    return name.startswith("lbfgs.")


def callees(spans) -> set:
    """The ids of the spans that run below an ``lbfgs.*`` span and are
    not one themselves."""
    by_id = {s.id: s for s in spans}
    out = set()
    for s in spans:
        if _optimizer(s.name):
            continue
        p = by_id.get(s.parent)
        while p is not None:
            if _optimizer(p.name):
                out.add(s.id)
                break
            p = by_id.get(p.parent)
    return out


def minus(a, b):
    """The time of sorted, disjoint intervals `a` outside those of `b`."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > s:
                out.append((s, b[k][0]))
            s = max(s, b[k][1])
            k += 1
        if s < e:
            out.append((s, e))
    return out


def per_step(trace, spans, steps: int) -> Optional[float]:
    inside = covered(trace, spans, _optimizer)
    if not inside or not steps:
        return None
    below = callees(spans)
    called = covered(trace, [s for s in spans if s.id in below],
                     lambda name: True)
    return overlap(idle(trace), minus(inside, called)) / 1e6 / steps


def read(r):
    spans = program_spans()
    if r.trace is None or not spans:
        return None
    return per_step(r.trace, spans,
                    r.record.steps_between(r.record.t_open,
                                           r.record.t_close))
