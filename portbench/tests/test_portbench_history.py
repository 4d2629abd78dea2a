"""The L-BFGS history's byte count (yardstick/history.py) and the reader
of ``history_roofline`` against hand counts: a synthetic trace whose
operations are matched to the ``lbfgs.history`` spans by correlation id,
and no spans or no trace."""

import dataclasses
import types
from typing import Optional

import pytest

from portbench.harness.record import RunRecord
from portbench.harness.trace import TraceData, Tracer
from portbench.metrics import held_idle_share, history_roofline
from portbench.yardstick import history


@dataclasses.dataclass
class S:
    name: str
    start_ns: int
    end_ns: int
    attrs: dict = dataclasses.field(default_factory=dict)
    id: int = 0
    parent: Optional[int] = None


@pytest.mark.parametrize("pairs,expected", [
    # 4 row reads of the held pairs (the products in one pass over each
    # of Y and S, the combination in one more), s and y written, 8 lane
    # vectors, and
    # P, Q (2 p^2) and rho (p) for the coefficients, 4 bytes each; n = 1000
    (0, 2 * 4000 + 8 * 4000),
    (1, 4 * 4000 + 2 * 4000 + 8 * 4000 + (2 + 1) * 4),
    (37, 4 * 37 * 4000 + 2 * 4000 + 8 * 4000 + (2 * 37 * 37 + 37) * 4),
    (100, 4 * 100 * 4000 + 2 * 4000 + 8 * 4000 + (2 * 100 * 100 + 100) * 4)])
def test_history_bytes_by_hand(pairs, expected):
    assert history.history_bytes(1, pairs, 1000) == expected


def test_history_bytes_lanes_and_dtype():
    """Two lanes of 37 pairs each are twice one lane; bfloat16 rows halve
    the row terms and leave the float32 vectors and coefficients."""
    assert history.history_bytes(2, 74, 1000) == 2 * history.history_bytes(
        1, 37, 1000)
    assert history.history_bytes(1, 37, 1000, row=2) == (
        4 * 37 * 2000 + 2 * 2000 + 8 * 4000 + (2 * 37 * 37 + 37) * 4)
    assert history.row_bytes({"lbfgs_state_dtype": "bfloat16"}) == 2
    assert history.row_bytes({"lbfgs_state_dtype": "float32"}) == 4


def test_history_bytes_at_the_cell():
    """The 2048 px top level (12,582,912 values) at 100 pairs: 20.6 GB a
    step, 6.16 ms at 3.35 TB/s."""
    n = 2048 * 2048 * 3
    b = history.history_bytes(1, 100, n)
    assert b == pytest.approx(4 * 100 * n * 4 + 10 * n * 4 + 80400)
    assert b / 3.35e12 == pytest.approx(6.16e-3, rel=1e-3)


def _spans():
    return [
        S("lbfgs.history", 100, 110, dict(lanes=1, pairs=0, n=1000)),
        S("lbfgs.history", 200, 210, dict(lanes=1, pairs=37, n=1000)),
        # no pairs yet (the job ended before a read): left out
        S("lbfgs.history", 300, 310, dict(lanes=1, n=1000)),
        # ends after the window's close: left out
        S("lbfgs.history", 990, 1010, dict(lanes=1, pairs=100, n=1000)),
        S("lbfgs.step", 90, 400, dict(lanes=1)),
    ]


LAUNCHES = [(105, 7),    # inside the first span
            (150, 8),    # between spans: the evaluation
            (205, 9),    # inside the second
            (305, 10),   # inside the span without pairs
            (1000, 11)]  # inside the span past the window
DEVICE = [(120, 140, 7), (140, 150, 7),   # the first span's graph
          (160, 190, 8),                  # not a history operation
          (220, 260, 9),                  # the second's
          (320, 330, 10), (1001, 1005, 11)]


def test_share_matches_operations_by_correlation_id():
    got = history_roofline.share(_spans(), LAUNCHES, DEVICE, (0, 1000), 4,
                                 1e9)
    nbytes = (history.history_bytes(1, 0, 1000)
              + history.history_bytes(1, 37, 1000))
    secs = (20 + 10 + 40) / 1e9
    assert got == pytest.approx(100.0 * nbytes / 1e9 / secs)


def test_share_reads_nothing_without_its_spans_or_operations():
    assert history_roofline.share([], LAUNCHES, DEVICE, (0, 1000), 4,
                                  1e9) is None
    spans = [s for s in _spans() if s.name != "lbfgs.history"]
    assert history_roofline.share(spans, LAUNCHES, DEVICE, (0, 1000), 4,
                                  1e9) is None
    # spans, but no runtime call inside them, or no operation of theirs
    assert history_roofline.share(_spans(), [], DEVICE, (0, 1000), 4,
                                  1e9) is None
    assert history_roofline.share(_spans(), LAUNCHES, [], (0, 1000), 4,
                                  1e9) is None


def _record(t_open, t_close):
    return RunRecord(jobs={}, t_start=0.0, t_open=t_open, t_close=t_close,
                     peak_setup_bytes=0, peak_window_bytes=0,
                     launches_window={})


def test_read_without_spans_or_trace_reads_nothing(monkeypatch):
    """A program that keeps no spans (as before the span existed), or a
    run with no trace, gives no number and raises nothing."""
    trace = TraceData(window_ns=(0, 1000), device=[], host=[],
                      host_launches=0, runtime_calls=0)
    r = types.SimpleNamespace(trace=trace, record=_record(1.0, 2.0),
                              fields={}, bytes_per_s=3.35e12)
    monkeypatch.setattr(held_idle_share, "program_spans", lambda: None)
    monkeypatch.setattr(history_roofline, "program_spans", lambda: None)
    assert history_roofline.read(r) is None
    monkeypatch.setattr(history_roofline, "program_spans", _spans)
    assert history_roofline.read(types.SimpleNamespace(
        trace=None, record=r.record, fields={}, bytes_per_s=3.35e12)) is None
    # spans, but no profiler session of this run's window
    assert history_roofline.read(r) is None


def test_the_runs_own_session_is_found_and_read():
    """The reader finds the run's Tracer by its window and reads its
    events; on the CPU there are no device operations, so no number."""
    tracer = Tracer()
    tracer.start()
    record = _record(tracer.open(), tracer.close())
    tracer.finish()
    assert history_roofline._tracer(record) is tracer
    assert history_roofline._tracer(_record(-1.0, -2.0)) is None
    _launches, device = history_roofline.events(tracer)
    assert device == []
    r = types.SimpleNamespace(trace=tracer.parse(), record=record,
                              fields={}, bytes_per_s=3.35e12)
    spans = _spans()
    assert history_roofline.share(spans, *history_roofline.events(tracer),
                                  r.trace.window_ns, 4, 3.35e12) is None
