"""The closed loop of ``lbfgs2k-solo`` (traffic/solo_locked.py): the
window's close runs under the program's device lock, and the cell runs
end to end on the CPU at a tiny size (4 levels, a 128 px top level)."""

import os
import threading

import pytest
import torch

from portbench import run as bench
from portbench.harness import session as session_mod
from portbench.harness.spec import load_cell, load_module

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SEED = 2 ** 31 + 1009  # above 32 signed bits, as a run's seed may be
solo_locked = load_module("traffic", "solo_locked")


class FakeSession:
    def __init__(self, lock):
        self.lock, self.seconds, self.held = lock, 51.0, None

    def close(self):
        self.held = self.lock.locked()
        return 2.0


def test_close_holds_the_lock_and_the_rest_is_the_sessions():
    lock = threading.Lock()
    fake = FakeSession(lock)
    locked = solo_locked.LockedClose(fake, lock)
    assert locked.close() == 2.0 and fake.held is True
    assert not lock.locked() and locked.seconds == 51.0


def test_the_lock_is_the_programs_graph_lock():
    from artstyletransfer_tpu_torch.engine import graphs

    assert solo_locked.program_lock("cpu") is graphs.device_lock("cpu")


def test_the_cell_runs_on_the_cpu(monkeypatch):
    """lbfgs2k-solo at base 16: one job through the online executor, the
    window closed under the lock, checked against the reference."""
    from artstyletransfer_tpu_torch.engine import graphs

    held = []
    real_close = session_mod.Session.close

    def close(self):
        held.append(graphs.device_lock("cpu").locked())
        return real_close(self)

    monkeypatch.setattr(session_mod.Session, "close", close)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        cell = load_cell("lbfgs2k-solo", ROOT)
        assert cell.traffic["entry"] == "solo_locked"
        result = bench.run_cell(cell, SEED, 6.0, False,
                                {"base_diameter": 16, "iters_num": 40,
                                 "stream_every": 2}, "cpu")
    finally:
        torch.set_num_threads(threads)
    assert held == [True]
    assert result["correct"] is True and result["attempted"] == 1
    assert set(result["metrics"]) == {"served_steps_per_s",
                                      "progress_gap_p95_s", "setup_s"}
    assert result["check"]["eval_spread"]["value"] < 1e-5


def test_a_program_without_the_lock_fails_the_run(monkeypatch):
    """The entry never closes a window without the lock: a program whose
    graphs module has no device_lock fails at the import."""
    import sys
    import types

    monkeypatch.setitem(sys.modules,
                        "artstyletransfer_tpu_torch.engine.graphs",
                        types.ModuleType("graphs"))
    with pytest.raises(ImportError):
        solo_locked.program_lock("cpu")
