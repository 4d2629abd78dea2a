"""Traffic, window arithmetic, cells found by name, and the check's
control and planted faults, at tiny sizes on the CPU."""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch

from portbench import run as bench
from portbench.harness import inputs
from portbench.harness.record import Job, Report, RunRecord
from portbench.harness.spec import load_cell, load_module

ROOT = bench.ROOT
BENCH = os.path.join(ROOT, "portbench")
TINY = {"base_diameter": 16, "iters_num": 30, "stream_every": 5}
SEED = 2 ** 31 + 977  # above 32 signed bits, as a run's seed may be


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def tiny_cell(name, **traffic):
    cell = load_cell(name, ROOT)
    return dataclasses.replace(cell, traffic={**cell.traffic, **traffic})


# -- traffic ----------------------------------------------------------------


def test_schedule_is_fixed_and_images_follow_the_seed():
    online = load_module("traffic", "online")
    t = dict(load_cell("lbfgs512-online", ROOT).traffic, rate=1.0)
    a, b = online.schedule(t, 40), online.schedule(t, 40)
    assert a == b and a == sorted(a)
    assert a[-1] < t["prefill_s"] + 40
    assert len(a) == pytest.approx(t["prefill_s"] + 40, rel=0.2)
    c1, s1 = inputs.job_images(SEED, 3, 32, 16)
    c2, s2 = inputs.job_images(SEED, 3, 32, 16)
    c3, _ = inputs.job_images(SEED + 1, 3, 32, 16)
    assert np.array_equal(c1, c2) and np.array_equal(s1, s2)
    assert not np.array_equal(c1, c3)
    w1, w2 = inputs.weights(SEED, "cpu"), inputs.weights(SEED, "cpu")
    assert all(np.array_equal(w1[k]["w"], w2[k]["w"]) for k in w1)


# -- window arithmetic ------------------------------------------------------


def record_of(reports_by_job, dues, t_open=10.0, t_close=20.0):
    jobs = {}
    for i, (reps, due) in enumerate(zip(reports_by_job, dues)):
        tid = f"j{i}"
        jobs[tid] = Job(tid, i, None, None, 0, due=due, added=due,
                        reports=[Report(t, d) for t, d in reps])
    return RunRecord(jobs=jobs, t_start=0.0, t_open=t_open, t_close=t_close,
                     peak_setup_bytes=0, peak_window_bytes=0,
                     launches_window={})


class R:
    def __init__(self, record, ops=1.0, peak=1.0):
        self.record = record
        self.evaluation = {"ops": ops}
        self.peak_ops = peak


def test_rates_and_percentiles_take_every_sample():
    """A burst of chunks from one job and a slow job: the rate counts every
    step in the window (not a mean of per-chunk rates), the tail is the
    tail of every gap, the step's share of peak is over the chunks that
    began and ended in the window."""
    fast = [(11.0 + 0.1 * k, 10 * (k + 1)) for k in range(50)]  # 500 steps
    slow = [(9.0, 10), (19.0, 20), (25.0, 30)]  # one report in the window
    rec = record_of([fast, slow, []], dues=[10.5, 5.0, 15.0])
    read = lambda m: load_module("metrics", m).read(R(rec))  # noqa: E731
    assert rec.steps_between(10.0, 20.0) == 500 + 10
    assert read("served_steps_per_s") == pytest.approx(51.0)
    gaps = [0.5] + [0.1] * 49 + [10.0]
    assert read("progress_gap_p95_s") == pytest.approx(
        np.percentile(gaps, 95))
    # fast's 49 chunks of 10 steps in 4.9 s; slow's chunk began before the
    # window opened
    assert read("step_mfu") == pytest.approx(100.0 * 490 / 4.9)


def test_memory_peak_is_the_allocated_peak_over_setup_and_window():
    rec = record_of([[]], dues=[None])
    rec.peak_setup_bytes, rec.peak_window_bytes = 39_200_000_000, 1_000
    assert load_module("metrics", "peak_mem_gb").read(R(rec)) == 39.2


# -- a cell, a configuration and a metric added as files --------------------


def test_new_cell_found_by_name_in_a_copy(tmp_path):
    """Files alone: a copy of the benchmark gains a configuration, a
    traffic mix, a cell and a metric; the harness finds and runs them by
    name, changing no file that was there."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench_json = json.load(fh)
    before = {p: (root / "portbench" / p).read_bytes()
              for p in ("traffic/solo.py", "traffic/online.py",
                        "harness/spec.py")}
    with open(os.path.join(BENCH, "configs", "vgg19-2l512-lbfgs.json")) as fh:
        config = json.load(fh)
    config["fields"].update(TINY, optimizer="adam")
    (root / "portbench/configs/tiny-adam.json").write_text(json.dumps(config))
    (root / "portbench/traffic/tiny-solo.json").write_text(json.dumps(
        {"entry": "solo", "aspect": 1.0, "max_jobs": 50, "max_batch": 8}))
    (root / "portbench/cells/tiny-adam-solo.json").write_text(json.dumps(
        {"jobs": 1, "limits": {"loss_shortfall": 0.5}}))
    (root / "portbench/metrics/jobs_started.py").write_text(
        "def read(r):\n    return float(r.record.attempted)\n")
    bench_json["configs"].append({"name": "tiny-adam", "source": "test",
                                  "file": "portbench/configs/tiny-adam.json",
                                  "reduced": [], "why": "test"})
    bench_json["workloads"].append({"name": "tiny-adam-solo",
                                    "config": "tiny-adam",
                                    "traffic": "tiny-solo", "chips": 1,
                                    "why": "test"})
    bench_json["end_to_end"].append({"name": "jobs_started", "unit": "jobs",
                                     "better": "higher", "bound": 0.25,
                                     "source": "host_clock",
                                     "workloads": ["tiny-adam-solo"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench_json))

    cell = load_cell("tiny-adam-solo", str(root), str(root / "portbench"))
    result = bench.run_cell(cell, SEED, 2.0, False, {}, "cpu")
    assert set(result["metrics"]) == {"setup_s", "jobs_started"}
    assert result["metrics"]["jobs_started"]["value"] >= 1
    assert result["device"]["platform"] == "cpu"
    assert "busy_s" not in result["device"] and "breakdown" not in result
    assert result["correct"] is True
    assert before == {p: (root / "portbench" / p).read_bytes()
                      for p in before}


# -- the control and the planted faults -------------------------------------

CELL = "lbfgs512-online"
# a tiny served mix: two jobs due in an 8 s window, each compared at its
# first image (32 px, 5 steps to an image)
QUICK = {"rate": 0.3, "prefill_s": 0.5}
SMALL = {**TINY, "base_diameter": 32}


def run_tiny(overrides=None, seconds=8.0):
    cell = tiny_cell(CELL, **QUICK)
    return bench.run_cell(cell, SEED, seconds, False,
                          {**SMALL, **(overrides or {})}, "cpu")


def test_control_fails_the_cell():
    """The control (the program's bfloat16 path) at a tiny size on the
    CPU: the sound run (float32 here) is correct, the control is not, by
    the spread of its evaluation gaps."""
    sound = run_tiny()
    control = run_tiny({"compute_dtype": "bfloat16"})
    assert sound["correct"] is True, sound["check"]
    assert control["correct"] is False, control["check"]
    spread = control["check"]["eval_spread"]
    assert spread["value"] > spread["limit"]


@pytest.fixture
def unchanged_state(monkeypatch):
    from artstyletransfer_tpu_torch.engine import transfer

    step = transfer._Lbfgs.step

    def frozen(self, x, s):
        _x, f = step(self, x, s)
        return x, f

    monkeypatch.setattr(transfer._Lbfgs, "step", frozen)


def test_fault_state_unchanged(unchanged_state):
    result = run_tiny()
    assert result["correct"] is False
    assert result["check"]["loss_shortfall"]["value"] > 0.9


def test_fault_answer_altered(monkeypatch):
    """The delivered image altered where the batch makes it."""
    from artstyletransfer_tpu_torch.parallel import batch

    unprepare = batch.unprepare_img

    def altered(x):
        img = unprepare(x)
        return img + 0.05 * np.sign(np.sin(np.arange(img.size))).reshape(
            img.shape).astype(np.float32)

    monkeypatch.setattr(batch, "unprepare_img", altered)
    assert run_tiny()["correct"] is False


@pytest.mark.card
def test_control_on_the_card(card):
    """The control at a reduced size on the card, on three seeds: the
    sound run (TF32 convolutions) correct, the bfloat16 control not."""
    cell = tiny_cell(CELL, rate=0.5, prefill_s=2.0)
    over = {"base_diameter": 128, "iters_num": 100, "stream_every": 10}
    for seed in (SEED, SEED + 1, SEED + 2):
        sound = bench.run_cell(cell, seed, 8.0, False, over, card)
        control = bench.run_cell(cell, seed, 8.0, False,
                                 {**over, "compute_dtype": "bfloat16"}, card)
        assert sound["correct"] is True, (seed, sound["check"])
        assert control["correct"] is False, (seed, control["check"])
