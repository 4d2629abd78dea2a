"""The port's spans (utils/metrics.py): kept only while a profiler session
runs, on the profiler's own clock, and placed at the serving, queue,
engine and optimizer boundaries of a served job."""

import asyncio
import json
import threading
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from artstyletransfer_tpu_torch.config import Config
from artstyletransfer_tpu_torch.engine import transfer
from artstyletransfer_tpu_torch.engine.transfer import ContentStylePair
from artstyletransfer_tpu_torch.runtime.online import OnlineBatchingExecutor
from artstyletransfer_tpu_torch.utils.metrics import (profile_trace,
                                                      recorded_spans, span)


def _named(name, since_ns):
    return [s for s in recorded_spans(since_ns) if s.name == name]


def _inside(inner, outer):
    return outer.start_ns <= inner.start_ns and inner.end_ns <= outer.end_ns


def test_nothing_is_recorded_without_a_profiler_session():
    t0 = time.time_ns()
    with span("test.off", task="off"):
        pass
    late = span("test.off")
    late.end()
    assert _named("test.off", t0) == []


def test_a_worker_thread_span_is_kept_while_a_main_thread_session_runs():
    t0 = time.time_ns()

    def work(name):
        with span(name, lanes=3):
            pass

    with profile(activities=[ProfilerActivity.CPU]):
        worker = threading.Thread(target=work, args=("test.during",))
        worker.start()
        worker.join(timeout=30)
    assert not worker.is_alive()
    worker = threading.Thread(target=work, args=("test.after",))
    worker.start()
    worker.join(timeout=30)
    assert not worker.is_alive()
    (during,) = _named("test.during", t0)
    assert during.attrs == {"lanes": 3}
    assert during.thread != threading.get_ident()
    assert _named("test.after", t0) == []


def test_a_span_brackets_the_profilers_own_event():
    """The spans' clock is the profiler's: a span around x @ x holds the
    profiler's aten::mm event, with no offset or fitting."""
    x = torch.randn(256, 256)
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("test.mm"):
            x @ x
    (around,) = _named("test.mm", t0)
    mms = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "aten::mm"]
    assert len(mms) == 1
    start = mms[0].start_ns()
    assert around.start_ns <= start
    assert start + mms[0].duration_ns() <= around.end_ns


def test_a_span_open_when_the_session_starts_keeps_its_true_start():
    t0 = time.time_ns()
    early = span("test.early")
    before = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        early.end()
    (kept,) = _named("test.early", t0)
    assert kept.start_ns <= before


def test_a_span_open_when_the_session_stops_is_kept():
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        late = span("test.late")
    late.end()
    assert len(_named("test.late", t0)) == 1


def test_spans_inherit_their_parents_task_and_name_their_parent():
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        with span("test.outer", task=("a", "b")) as outer:
            with span("test.inner") as inner:
                pass
        handed = threading.Thread(
            target=lambda: span("test.handed", parent=outer).end())
        handed.start()
        handed.join(timeout=30)
    assert inner.parent == outer.id and inner.task == ("a", "b")
    (moved,) = _named("test.handed", t0)
    assert moved.parent == outer.id and moved.task == ("a", "b")
    assert outer.parent is None


def test_profile_trace_writes_the_spans_beside_the_trace(tmp_path):
    with profile_trace(str(tmp_path)):
        with span("test.traced", task="t", rounds=2):
            pass
    assert (tmp_path / "trace.json").exists()
    events = [json.loads(line) for line in
              (tmp_path / "spans.jsonl").read_text().splitlines()]
    (traced,) = [e for e in events if e["name"] == "test.traced"]
    assert traced["event"] == "span" and traced["task"] == "t"
    assert traced["rounds"] == 2
    assert traced["start_ns"] <= traced["end_ns"]


def test_one_served_lbfgs_job_has_its_spans(vgg_params, monkeypatch):
    """A CPU OnlineBatchingExecutor run of one tiny L-BFGS job: the job's
    serving, queue, engine and optimizer spans nest as the code does,
    share its task id, and count one lbfgs.step per optimizer step with
    the loss-and-gradient evaluations that a wrapped LossGrad counts."""
    torch.set_num_threads(1)
    calls = []
    real_call = transfer.LossGrad.__call__

    def counted(self, x):
        calls.append(x.shape[0])
        return real_call(self, x)

    monkeypatch.setattr(transfer.LossGrad, "__call__", counted)
    cfg = Config(levels_num=1, iters_num=3, base_diameter=16,
                 optimizer="lbfgs", lbfgs_history=3, stream_every=2)
    ex = OnlineBatchingExecutor(cfg, verbose=False, canonicalize=False,
                                batch_window_s=0.05, device="cpu",
                                params=vgg_params)
    rng = np.random.default_rng(0)
    pair = ContentStylePair(
        ("c.jpg", rng.random((16, 16, 3)).astype(np.float32)),
        ("s.jpg", rng.random((16, 16, 3)).astype(np.float32)))
    tid = "spans-job"

    async def serve():
        await ex.add_task(tid, pair)
        await ex.run()
        await ex.aclose()

    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        asyncio.run(serve())
    assert ex.failures == {}

    spans = recorded_spans(t0)
    by_id = {s.id: s for s in spans}

    def of(name):
        return [s for s in spans if s.name == name]

    def serves(s):
        return s.task == tid or (isinstance(s.task, tuple)
                                 and tid in s.task)

    def parent_name(s):
        return by_id[s.parent].name if s.parent in by_id else None

    (job,) = of("online.job")
    (queued,) = of("online.queued")
    (round_,) = of("online.round")
    (group,) = of("queue.group")
    (setup,) = of("queue.job_setup")
    coalesce = of("online.coalesce")
    assert coalesce and all(_inside(c, job) for c in coalesce)
    for inner, outer in [(queued, job), (round_, job), (group, round_),
                         (setup, group)]:
        assert _inside(inner, outer), (inner.name, outer.name)
        assert serves(inner) and serves(outer)
    assert parent_name(queued) == "online.job"
    assert parent_name(group) == "online.round"
    assert parent_name(setup) == "queue.group"
    assert group.attrs == {"lanes": 1, "pad_lanes": 0, "attempt": 0}
    assert round_.attrs == {"jobs": 1}

    chunks = of("engine.chunk")
    assert [c.attrs["steps"] for c in chunks] == [2, 1]
    steps = of("lbfgs.step")
    assert len(steps) == cfg.iters_num
    for s in steps:
        assert serves(s) and parent_name(s) == "engine.chunk"
        assert any(_inside(s, c) for c in chunks)
        assert _inside(s, round_)
    searches = of("lbfgs.search")
    assert len(searches) == len(steps)
    for s in searches:
        assert parent_name(s) == "lbfgs.step" and serves(s)
    reads = of("lbfgs.read")
    assert reads and all(serves(r) for r in reads)
    in_search = [r for r in reads if parent_name(r) == "lbfgs.search"]
    assert in_search
    for r in in_search:
        assert _inside(r, by_id[r.parent])
    assert len(of("lbfgs.direction")) == len(steps)
    # one lbfgs.read per search round, beside d_norm's in every search
    assert len(in_search) == sum(s.attrs["rounds"] + 1 for s in searches)

    # init_opt's evaluation runs in the job's set-up, before any step
    assert sum(s.attrs["evals"] for s in steps) == len(calls) - 1
    assert all(s.attrs["lanes"] == 1 for s in steps)
    assert [s.attrs["evals"] for s in steps] == [
        s.attrs["rounds"] for s in searches]
    evals = of("engine.eval")
    assert len(evals) == len(calls)
    assert sum(1 for e in evals if parent_name(e) == "queue.job_setup") == 1

    delivered = of("online.deliver")
    assert len(delivered) == 2 and all(d.task == tid for d in delivered)
    assert all(_inside(d, job) for d in delivered)
    assert len(of("engine.materialize")) == 2


def test_a_tasks_queue_wait_ends_when_its_own_group_starts(vgg_params):
    """Two L-BFGS jobs taken by one round run one group after the other
    (the sequential policy): the second job's online.queued span lasts
    until its own group starts, after the first group has ended."""
    torch.set_num_threads(1)
    cfg = Config(levels_num=1, iters_num=2, base_diameter=16,
                 optimizer="lbfgs", lbfgs_history=2, stream_every=2)
    ex = OnlineBatchingExecutor(cfg, verbose=False, canonicalize=False,
                                batch_window_s=0.2, device="cpu",
                                params=vgg_params)
    rng = np.random.default_rng(1)

    def pair():
        return ContentStylePair(
            ("c.jpg", rng.random((16, 16, 3)).astype(np.float32)),
            ("s.jpg", rng.random((16, 16, 3)).astype(np.float32)))

    async def serve():
        await ex.add_task("first", pair())
        await ex.add_task("second", pair())
        await ex.run()
        await ex.aclose()

    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        asyncio.run(serve())
    assert ex.failures == {} and ex.dispatch_rounds == 1

    def one(name, tid):
        (s,) = [s for s in recorded_spans(t0) if s.name == name
                and (s.task == tid or s.task == (tid,))]
        return s

    first, second = one("queue.group", "first"), one("queue.group",
                                                     "second")
    assert first.end_ns <= second.start_ns
    for tid, group in (("first", first), ("second", second)):
        queued = one("online.queued", tid)
        assert _inside(queued, one("online.job", tid))
        assert queued.end_ns <= group.start_ns
    waited = one("online.queued", "second")
    assert waited.end_ns >= first.end_ns
    assert one("online.queued", "first").end_ns <= first.start_ns
