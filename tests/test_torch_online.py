"""The port's online batching executor (runtime/online.py) on the CPU:
round coalescing through an injected queue runner, the round path through
the port's run_job_queue, and live serving through LiveBatchRunners.
Mirrors tests/test_online.py (the JAX package's executor tests) at its
shapes (levels_num=1, base_diameter=16, seeded VGG19 weights); the
progress table's copy-on-read contract is runtime/executor.py's.

Also one test per fixed fault of the JAX package's executor (ROADMAP
Queue 3): the live path honours `retries`, and an error outside a chunk
fails every task the live drive holds instead of stranding joiners. A
live retry waits retry_delay_s, as the round path's attempts do, without
holding up the other buckets, and aclose cancels a waiting retry.
"""

import asyncio
import time

import numpy as np
import pytest
import torch

from artstyletransfer_tpu_torch.config import Config
from artstyletransfer_tpu_torch.engine.transfer import ContentStylePair
from artstyletransfer_tpu_torch.parallel import batch as pbatch
from artstyletransfer_tpu_torch.parallel import live as live_mod
from artstyletransfer_tpu_torch.runtime.online import OnlineBatchingExecutor

LIVE = dict(levels_num=1, base_diameter=16, optimizer="adam")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny shapes: one intra-op thread runs them as fast as many, and
    parallel test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(seed=0, shape=(16, 16, 3)):
    rng = np.random.default_rng(seed)
    return ContentStylePair(
        ("c.jpg", rng.random(shape).astype(np.float32)),
        ("s.jpg", rng.random(shape).astype(np.float32)))


def _executor(cfg, **kw):
    kw = {**dict(verbose=False, canonicalize=False, batch_window_s=0.0,
                 device="cpu"), **kw}
    return OnlineBatchingExecutor(cfg, **kw)


class FakeQueueRunner:
    """Records every run_job_queue call; completes all jobs instantly."""

    def __init__(self, delay_s=0.0, fail_ids=()):
        self.calls = []
        self.delay_s = delay_s
        self.fail_ids = set(fail_ids)

    def __call__(self, jobs, cfg, params=None, mesh=None, progress=None,
                 batch_policy="auto", max_batch=None, pad_batches=False,
                 retries=0, retry_delay_s=25.0, stream_images=True,
                 canonicalize_styles=False, canonicalize_contents=False,
                 device=None):
        self.calls.append([j[0] for j in jobs])
        self.retries = (retries, retry_delay_s)
        self.pad_batches = pad_batches
        self.stream_images = stream_images
        self.device = device
        if self.delay_s:
            time.sleep(self.delay_s)
        results, failures = {}, {}
        for tid, content, _style in jobs:
            if tid in self.fail_ids:
                failures[tid] = RuntimeError("poisoned")
                continue
            img = np.full_like(content, 0.5)
            if progress is not None:
                progress(tid, 50.0, img, 2.0)
                progress(tid, 100.0, img, 1.0)
            results[tid] = img
        return results, failures


def _progress(ex, tids):
    async def read():
        return {tid: await ex.get_progress(tid) for tid in tids}

    return asyncio.run(read())


def test_online_coalesces_concurrent_tasks_into_one_round():
    """4 concurrent same-bucket add_tasks -> one queue-runner call with all
    4 jobs, padded batches on, the executor's device passed on."""
    runner = FakeQueueRunner()
    ex = _executor(Config(iters_num=2), queue_runner=runner,
                   batch_window_s=0.05)

    async def go():
        for i in range(4):
            await ex.add_task(f"t{i}", _pair(i))
        await ex.run()

    asyncio.run(go())
    assert runner.calls == [["t0", "t1", "t2", "t3"]]
    assert ex.dispatch_rounds == 1
    assert runner.pad_batches is True and runner.device == ex.device
    for pct, img in _progress(ex, [f"t{i}" for i in range(4)]).values():
        assert pct == 100.0 and img is not None


def test_online_forwards_stream_images_to_queue():
    runner = FakeQueueRunner()
    ex = _executor(Config(iters_num=2), queue_runner=runner,
                   stream_images=False)

    async def go():
        await ex.add_task("t0", _pair(0))
        await ex.run()

    asyncio.run(go())
    assert runner.stream_images is False and runner.calls == [["t0"]]


def test_online_arrivals_during_run_join_next_round():
    """Round mode: tasks arriving while a round runs form the next one."""
    runner = FakeQueueRunner(delay_s=0.3)
    ex = _executor(Config(iters_num=2), queue_runner=runner,
                   batch_window_s=0.02)

    async def go():
        await ex.add_task("a0", _pair(0))
        await ex.add_task("a1", _pair(1))
        await asyncio.sleep(0.15)  # round 1 is now inside the runner
        await ex.add_task("b0", _pair(2))
        await ex.add_task("b1", _pair(3))
        await ex.run()

    asyncio.run(go())
    assert runner.calls == [["a0", "a1"], ["b0", "b1"]]
    assert ex.dispatch_rounds == 2


def test_online_failures_isolated_and_reported():
    runner = FakeQueueRunner(fail_ids={"bad"})
    reported = []

    async def on_failure(tid, exc):
        reported.append((tid, str(exc)))

    ex = _executor(Config(iters_num=2), queue_runner=runner,
                   report_failure=on_failure)

    async def go():
        await ex.add_task("ok", _pair(0))
        await ex.add_task("bad", _pair(1))
        await ex.run()

    asyncio.run(go())
    assert set(ex.failures) == {"bad"}
    assert isinstance(ex.failures["bad"], RuntimeError)
    assert reported == [("bad", "poisoned")]
    assert _progress(ex, ["ok"])["ok"][0] == 100.0


def test_online_report_progress_callback_streams():
    """The report_progress coroutine fires per chunk with (task_id,
    (percent, image)); get_progress hands out copies."""
    seen = []

    async def report(tid, result):
        seen.append((tid, result[0], result[1] is not None))

    ex = _executor(Config(iters_num=2), queue_runner=FakeQueueRunner(),
                   report_progress=report)

    async def go():
        await ex.add_task("t", _pair(0))
        await ex.run()
        pct, img = await ex.get_progress("t")
        img[...] = -1.0
        return (await ex.get_progress("t"))[1]

    again = asyncio.run(go())
    assert seen == [("t", 50.0, True), ("t", 100.0, True)]
    assert (again == 0.5).all()


def test_online_aclose_cancels_dispatcher():
    runner = FakeQueueRunner()
    ex = _executor(Config(iters_num=2), queue_runner=runner)

    async def go():
        await ex.add_task("t", _pair(0))
        await ex.run()
        await ex.aclose()
        await ex.aclose()  # idempotent

    asyncio.run(go())
    assert ex.failures == {} and runner.calls == [["t"]]


def test_online_refuses_a_mesh_and_needs_cuda_by_default(monkeypatch):
    with pytest.raises(NotImplementedError, match="mesh"):
        OnlineBatchingExecutor(Config(), mesh=object(), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        OnlineBatchingExecutor(Config())


def test_online_round_path_runs_run_job_queue(vgg_params, monkeypatch):
    """A sequential-policy config (lr-opening full-Wolfe L-BFGS) is served
    by rounds through the port's run_job_queue: single-job batches."""
    built = []
    real_cls = pbatch.BatchedTransferJob

    class SpyBatch(real_cls):
        def __init__(self, contents, styles, *a, **kw):
            built.append(len(contents))
            super().__init__(contents, styles, *a, **kw)

    monkeypatch.setattr(pbatch, "BatchedTransferJob", SpyBatch)
    cfg = Config(levels_num=1, iters_num=2, base_diameter=16,
                 optimizer="lbfgs", lbfgs_history=3, stream_every=2)
    ex = _executor(cfg, params=vgg_params, batch_window_s=0.05)
    assert not ex._use_live()

    async def go():
        for i in range(2):
            await ex.add_task(f"job{i}", _pair(i))
        await ex.run()

    asyncio.run(go())
    assert built == [1, 1] and ex.failures == {}
    for pct, img in _progress(ex, ["job0", "job1"]).values():
        assert pct == 100.0 and img.shape == (16, 16, 3)


def test_online_real_engine_runs_one_batch(vgg_params, monkeypatch):
    """End to end with the real engine: 4 concurrent same-shape jobs run
    as one BatchedTransferJob of 4 lanes (spied), canonicalized, and every
    task completes with a real image."""
    built = []
    real_cls = pbatch.BatchedTransferJob

    class SpyBatch(real_cls):
        def __init__(self, contents, styles, *a, **kw):
            built.append(len(contents))
            super().__init__(contents, styles, *a, **kw)

    monkeypatch.setattr(pbatch, "BatchedTransferJob", SpyBatch)
    cfg = Config(**LIVE, iters_num=2, stream_every=2)
    ex = _executor(cfg, params=vgg_params, canonicalize=True,
                   batch_window_s=0.05)
    assert ex._use_live()

    async def go():
        for i in range(4):
            await ex.add_task(f"job{i}", _pair(i))
        await ex.run()

    asyncio.run(go())
    assert built == [4] and ex.failures == {}
    for pct, img in _progress(ex, [f"job{i}" for i in range(4)]).values():
        assert pct == 100.0 and img is not None and img.ndim == 3


def test_online_live_bucket_failure_isolated(vgg_params, monkeypatch):
    """A runner whose step raises fails only its own bucket's tasks; the
    other bucket completes."""
    real_step = live_mod.LiveBatchRunner.step

    def poisoned_step(self):
        if any(t.startswith("bad") for t in self.all_tids):
            raise RuntimeError("injected device failure")
        return real_step(self)

    monkeypatch.setattr(live_mod.LiveBatchRunner, "step", poisoned_step)
    ex = _executor(Config(**LIVE, iters_num=4, stream_every=2),
                   params=vgg_params)

    async def go():
        await ex.add_task("bad0", _pair(0))                    # 16x16
        await ex.add_task("good0", _pair(1, shape=(24, 16, 3)))
        await ex.run()

    asyncio.run(go())
    assert set(ex.failures) == {"bad0"}
    assert "injected device failure" in str(ex.failures["bad0"])
    pct, img = _progress(ex, ["good0"])["good0"]
    assert pct == 100.0 and img is not None


@pytest.mark.parametrize("retries", [0, 1])
def test_online_live_retries_a_failed_bucket(vgg_params, monkeypatch,
                                             retries):
    """Fault 3 of the JAX package (runtime/online.py:372-378): a runner
    that fails once, mid-flight, then succeeds. With retries=1 its tasks
    are resubmitted fresh and finish; with retries=0 they fail."""
    real_step = live_mod.LiveBatchRunner.step
    steps = []

    def flaky_step(self):
        steps.append(list(self.all_tids))
        if len(steps) == 2:
            raise RuntimeError("transient device failure")
        return real_step(self)

    monkeypatch.setattr(live_mod.LiveBatchRunner, "step", flaky_step)
    ex = _executor(Config(**LIVE, iters_num=4, stream_every=2),
                   params=vgg_params, retries=retries, retry_delay_s=0.0)

    async def go():
        await ex.add_task("a", _pair(0))
        await ex.add_task("b", _pair(1))
        await ex.run()

    asyncio.run(go())
    if retries:
        assert ex.failures == {}
        for pct, img in _progress(ex, ["a", "b"]).values():
            assert pct == 100.0 and img is not None
        assert len(steps) == 4  # 2 chunks, the failed one, 2 again
    else:
        assert set(ex.failures) == {"a", "b"} and len(steps) == 2


def test_online_live_error_outside_a_chunk_fails_every_held_task(
        vgg_params):
    """Fault 4 of the JAX package (runtime/online.py:227-229): a
    report_progress hook that raises outside runner.step fails the first
    task AND the one that joined mid-flight (the JAX package leaves the
    joiner at its last progress forever), and drops the runners."""
    seen = []

    async def report(tid, value):
        seen.append((tid, value[0]))
        if tid == "B":
            raise RuntimeError("report hook failed")

    ex = _executor(Config(**LIVE, iters_num=8, stream_every=2),
                   params=vgg_params, report_progress=report)

    async def go():
        await ex.add_task("A", _pair(0))
        for _ in range(1200):  # A's first chunk reported
            if seen:
                break
            await asyncio.sleep(0.05)
        await ex.add_task("B", _pair(1))
        await asyncio.wait_for(ex.run(), timeout=60)

    asyncio.run(go())
    assert ("B", 25.0) in seen
    assert set(ex.failures) == {"A", "B"}
    assert "report hook failed" in str(ex.failures["B"])
    assert ex._runners == {}


def test_online_live_join_bounds_newcomer_wait(vgg_params):
    """Through the executor (batch_join default): a task added while a
    batch is in flight gets its first progress before the in-flight task
    completes (the round path made it wait out the whole round). The
    dispatch loop awaits each report, so A's first report holds A's next
    chunk until B is queued: B arrives while A is in flight however fast
    A's chunks run."""
    events = []
    b_queued = asyncio.Event()

    async def report(tid, value):
        events.append((tid, value[0]))
        if len(events) == 1:
            await asyncio.wait_for(b_queued.wait(), timeout=60)

    ex = _executor(Config(**LIVE, iters_num=8, stream_every=2),
                   params=vgg_params, report_progress=report)
    assert ex._use_live()

    async def go():
        await ex.add_task("A", _pair(0))
        for _ in range(1200):  # A's first chunk reported
            if events:
                break
            await asyncio.sleep(0.05)
        await ex.add_task("B", _pair(1))
        b_queued.set()
        await ex.run()

    asyncio.run(go())
    b_first = next(i for i, (t, _p) in enumerate(events) if t == "B")
    a_done = next(i for i, (t, p) in enumerate(events)
                  if t == "A" and p >= 100.0)
    assert b_first < a_done, events
    assert ex.failures == {}
    for pct, img in _progress(ex, ["A", "B"]).values():
        assert pct == 100.0 and img is not None


def test_online_live_global_lane_budget(vgg_params, monkeypatch):
    """Concurrent runners hold their batch states at once, so jobs enter
    runners first in, first out only within the global padded-lane budget
    (max_batch): a 4-task flood over two buckets with budget 2 completes
    4/4, never holding more than 2 reserved lanes."""
    max_seen = 0
    runners_seen = []
    real_step = live_mod.LiveBatchRunner.step
    real_init = live_mod.LiveBatchRunner.__init__

    def spy_step(self):
        nonlocal max_seen
        max_seen = max(max_seen, sum(r.lanes_reserved
                                     for r in runners_seen))
        return real_step(self)

    def spy_init(self, *a, **kw):
        runners_seen.append(self)
        real_init(self, *a, **kw)

    monkeypatch.setattr(live_mod.LiveBatchRunner, "step", spy_step)
    monkeypatch.setattr(live_mod.LiveBatchRunner, "__init__", spy_init)
    ex = _executor(Config(**LIVE, iters_num=4, stream_every=2),
                   params=vgg_params, max_batch=2)

    async def go():
        for i in range(2):
            await ex.add_task(f"a{i}", _pair(i))                  # 16x16
        for i in range(2):
            await ex.add_task(f"b{i}", _pair(i, shape=(24, 16, 3)))
        await ex.run()

    asyncio.run(go())
    assert ex.failures == {}
    assert len(runners_seen) == 2 and max_seen <= 2, max_seen
    for pct, _img in _progress(ex, ["a0", "a1", "b0", "b1"]).values():
        assert pct == 100.0


def test_online_round_path_passes_retries_and_their_delay():
    runner = FakeQueueRunner()
    ex = _executor(Config(iters_num=2), queue_runner=runner, retries=2,
                   retry_delay_s=1.5)

    async def go():
        await ex.add_task("t", _pair(0))
        await ex.run()

    asyncio.run(go())
    assert runner.retries == (2, 1.5)
    assert OnlineBatchingExecutor(Config(), device="cpu").retry_delay_s == 25.0


def _flaky_first_step(monkeypatch, stamps):
    """LiveBatchRunner.step that records (time, tids, outcome) and raises
    at the first step of a runner holding a 'bad' task."""
    real_step = live_mod.LiveBatchRunner.step

    def step(self):
        tids = sorted(self.all_tids)
        if any(t.startswith("bad") for t in tids) and not stamps:
            stamps.append((time.perf_counter(), tids, "failed"))
            raise RuntimeError("transient device failure")
        out = real_step(self)
        stamps.append((time.perf_counter(), tids, "stepped"))
        return out

    monkeypatch.setattr(live_mod.LiveBatchRunner, "step", step)


def test_online_live_retry_waits_while_other_buckets_step(vgg_params,
                                                          monkeypatch):
    """A failed bucket's task is resubmitted no sooner than retry_delay_s
    after the failure, and another bucket keeps stepping meanwhile; both
    finish."""
    stamps = []
    _flaky_first_step(monkeypatch, stamps)
    delay = 0.3
    ex = _executor(Config(**LIVE, iters_num=12, stream_every=2),
                   params=vgg_params, retries=1, retry_delay_s=delay)

    async def go():
        await ex.add_task("bad0", _pair(0))                     # 16x16
        await ex.add_task("good0", _pair(1, shape=(24, 16, 3)))
        await asyncio.wait_for(ex.run(), timeout=120)

    asyncio.run(go())
    assert ex.failures == {}
    for pct, img in _progress(ex, ["bad0", "good0"]).values():
        assert pct == 100.0 and img is not None
    t_fail = stamps[0][0]
    assert stamps[0][1:] == (["bad0"], "failed")
    t_retry = next(t for t, tids, what in stamps[1:] if tids == ["bad0"])
    assert t_retry - t_fail >= delay
    assert any(t_fail < t < t_retry for t, tids, _w in stamps
               if tids == ["good0"])


def test_online_aclose_cancels_a_waiting_retry(vgg_params, monkeypatch):
    """aclose while a failed bucket's task waits out retry_delay_s leaves
    no requeue pending and no task running on the loop."""
    stamps = []
    _flaky_first_step(monkeypatch, stamps)
    ex = _executor(Config(**LIVE, iters_num=4, stream_every=2),
                   params=vgg_params, retries=1, retry_delay_s=30.0)

    async def go():
        await ex.add_task("bad0", _pair(0))
        for _ in range(1200):
            if stamps:
                break
            await asyncio.sleep(0.01)
        await asyncio.sleep(0.1)  # the retry is scheduled, not yet due
        waiting = dict(ex._OnlineBatchingExecutor__delayed)
        await asyncio.wait_for(ex.aclose(), timeout=10)
        others = asyncio.all_tasks() - {asyncio.current_task()}
        return waiting, others

    waiting, others = asyncio.run(go())
    assert [[t for t, _c, _s in v] for v in waiting.values()] == [["bad0"]]
    assert all(w.cancelled() for w in waiting)
    assert ex._OnlineBatchingExecutor__delayed == {}
    assert others == set()
    assert [what for _t, _tids, what in stamps] == ["failed"]
