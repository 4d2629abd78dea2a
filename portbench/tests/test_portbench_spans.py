"""The four readers of the program's spans against hand counts, on a
synthetic trace and a synthetic span list: overlapping spans counted
once, spans cut by the window, and no spans."""

import dataclasses
import types
from typing import Optional

import pytest

from portbench.harness.record import Job, Report, RunRecord
from portbench.harness.trace import TraceData
from portbench.metrics import (admit_wait_p50_s, held_idle_share,
                               job_setup_p50_s, optimizer_idle_ms_per_step)


@dataclasses.dataclass
class S:
    name: str
    start_ns: int
    end_ns: int
    id: int = 0
    parent: Optional[int] = None


# window [100, 200); the device busy on [100, 120), [150, 160), [190, 195):
# idle [120, 150), [160, 190), [195, 200)
TRACE = TraceData(window_ns=(100, 200),
                  device=[(100, 110, "a"), (105, 120, "b"), (150, 160, "c"),
                          (190, 195, "d")],
                  host=[], host_launches=0, runtime_calls=0)


def test_idle_is_the_windows_complement_of_the_busy_intervals():
    assert held_idle_share.idle(TRACE) == [(120, 150), (160, 190),
                                          (195, 200)]


def test_held_idle_share_counts_overlaps_once_and_cuts_to_the_window():
    spans = [S("online.job", 50, 130),     # cut to [100, 130): 10 idle
             S("online.job", 125, 155),    # with it: [100, 155), 30 idle
             S("online.job", 170, 260),    # cut to [170, 200): 20 + 5 idle
             S("online.queued", 100, 200)]  # not a job
    held = 55 + 30
    assert held_idle_share.share(TRACE, spans) == pytest.approx(
        100.0 * (30 + 25) / held)


def test_held_idle_share_without_jobs_in_the_window_reads_nothing():
    assert held_idle_share.share(TRACE, []) is None
    assert held_idle_share.share(TRACE, [S("online.job", 0, 90),
                                         S("online.job", 200, 300)]) is None


def test_admit_wait_and_job_setup_take_the_median_of_spans_ending_inside():
    spans = [S("online.queued", 0, 150),     # 150 ns, ends inside
             S("online.queued", 140, 170),   # 30
             S("online.queued", 120, 140),   # 20
             S("online.queued", 90, 99),     # ends before the window
             S("online.queued", 150, 250),   # ends after it
             S("queue.job_setup", 110, 150),  # 40
             S("queue.job_setup", 160, 170)]  # 10
    assert admit_wait_p50_s.median_of(TRACE, spans, "online.queued") == (
        pytest.approx(30e-9))
    assert admit_wait_p50_s.median_of(TRACE, spans, "queue.job_setup") == (
        pytest.approx(25e-9))
    assert admit_wait_p50_s.median_of(TRACE, spans[:1], "nothing") is None


def test_optimizer_idle_per_step_unions_every_lbfgs_span():
    spans = [S("lbfgs.step", 110, 155),      # idle [120, 150): 30
             S("lbfgs.search", 115, 152),    # inside the step: once
             S("lbfgs.read", 140, 165),      # adds [160, 165): 5
             S("lbfgs.read", 196, 240),      # cut to [196, 200): 4
             S("engine.eval", 160, 190)]     # not the optimizer's
    got = optimizer_idle_ms_per_step.per_step(TRACE, spans, steps=3)
    assert got == pytest.approx((30 + 5 + 4) / 1e6 / 3)
    assert optimizer_idle_ms_per_step.per_step(TRACE, spans, 0) is None
    assert optimizer_idle_ms_per_step.per_step(TRACE, [], 3) is None


def test_optimizer_idle_per_step_leaves_out_the_spans_it_calls_into():
    """An evaluation inside the line search (and a capture inside that)
    is the engine's idle, not the optimizer's; a span of another thread
    that only overlaps in time stays in."""
    spans = [S("lbfgs.step", 110, 155, id=1),
             S("lbfgs.search", 115, 152, id=2, parent=1),
             S("engine.eval", 125, 135, id=3, parent=2),     # 10 idle out
             S("graph.capture", 140, 145, id=4, parent=3),   # 5 idle out
             S("online.deliver", 145, 150, id=5),           # not below it
             S("engine.eval", 160, 190, id=6)]              # not inside
    assert optimizer_idle_ms_per_step.callees(spans) == {3, 4}
    got = optimizer_idle_ms_per_step.per_step(TRACE, spans, steps=2)
    assert got == pytest.approx((30 - 10 - 5) / 1e6 / 2)


def test_minus_takes_one_interval_list_out_of_another():
    minus = optimizer_idle_ms_per_step.minus
    assert minus([(0, 10), (20, 30)], [(2, 4), (5, 25), (29, 40)]) == [
        (0, 2), (4, 5), (25, 29)]
    assert minus([(0, 10)], []) == [(0, 10)]
    assert minus([(0, 10)], [(0, 10)]) == []


def _readings(trace):
    job = Job(tid="j", index=0, content=None, style=None, noise_seed=0,
              reports=[Report(1.0, 10), Report(2.0, 20)])
    record = RunRecord(jobs={"j": job}, t_start=0.0, t_open=0.5,
                       t_close=3.0, peak_setup_bytes=0, peak_window_bytes=0,
                       launches_window={})
    return types.SimpleNamespace(trace=trace, record=record)


@pytest.mark.parametrize("reader", [held_idle_share, admit_wait_p50_s,
                                    job_setup_p50_s,
                                    optimizer_idle_ms_per_step])
def test_a_reader_without_spans_reads_nothing(reader, monkeypatch):
    """A program that keeps no spans (or a run with no trace) gives no
    number, and raises nothing."""
    monkeypatch.setattr(held_idle_share, "program_spans", lambda: None)
    monkeypatch.setattr(reader, "program_spans", lambda: None)
    assert reader.read(_readings(TRACE)) is None
    monkeypatch.setattr(reader, "program_spans",
                        lambda: [S("online.job", 0, 300)])
    assert reader.read(_readings(None)) is None


def test_the_readers_read_the_programs_own_spans(monkeypatch):
    spans = [S("online.job", 100, 200), S("online.queued", 100, 150),
             S("queue.job_setup", 150, 160), S("lbfgs.step", 160, 190)]
    for reader in (held_idle_share, admit_wait_p50_s, job_setup_p50_s,
                   optimizer_idle_ms_per_step):
        monkeypatch.setattr(reader, "program_spans", lambda: spans)
    r = _readings(TRACE)
    assert held_idle_share.read(r) == pytest.approx(65.0)
    assert admit_wait_p50_s.read(r) == pytest.approx(50e-9)
    assert job_setup_p50_s.read(r) == pytest.approx(10e-9)
    # 20 job-steps reported in (0.5, 3.0]; 30 ns idle under lbfgs.step
    assert optimizer_idle_ms_per_step.read(r) == pytest.approx(30e-6 / 20)


def test_program_spans_reads_the_ports_recorder():
    from torch.profiler import ProfilerActivity, profile

    from artstyletransfer_tpu_torch.utils.metrics import span

    with profile(activities=[ProfilerActivity.CPU]):
        with span("test.portbench"):
            pass
    assert "test.portbench" in {s.name for s in
                                held_idle_share.program_spans()}
