"""Online batching executor: live serving through the batched path.

The port of the JAX package's ``runtime/online.py``. The reference's
serving model runs N jobs "2 at a time" behind a global semaphore
(reference task_executor.py:9, config.py:1): each concurrent request owns
the card in turns. This executor serves live traffic instead: concurrent
``add_task``s are canonicalized onto the serving shape buckets
(parallel/batch.py), held for a short coalescing window, and run as one
batch of lanes per bucket instead of interleaved single jobs.

Scheduling (batch_join=True, the default):
- LIVE JOINS: per-bucket ``parallel.live.LiveBatchRunner``s own the
  in-flight batches; a task arriving while its bucket is optimizing
  enters the batch at the next chunk boundary (state transplant and the
  per-lane-step chunk), so its first progress is about one chunk away,
  not a whole round. Active buckets run round-robin, one chunk each.
  Sequential-policy configs (lr-opening full-Wolfe L-BFGS) keep the round
  mode below.
- ROUND mode (batch_join=False, an injected queue_runner, or a
  sequential-policy config): everything pending when the card frees up
  (plus a `batch_window_s` coalescing window) forms the next round
  through ``parallel.run_job_queue``; tasks arriving mid-round wait for
  the next one.
- The API is a drop-in for runtime.executor.Executor (add_task /
  get_progress / task_ids / run / failures / report_progress callback).

Divergences from the JAX package (deliberate; ROADMAP Queue 3): the live
path honours `retries` (a failed bucket's tasks are resubmitted fresh up
to `retries` times before their failures are recorded), and it waits
`retry_delay_s` before each resubmission, as the round path's
run_job_queue waits between its attempts (the JAX live path has no
retries at all); the wait is scheduled on the event loop, so the other
buckets' chunks and new arrivals go on meanwhile. An error outside a
chunk fails every task the live drive holds and drops its runners, where
the JAX package fails only the tasks it drained first.
Runs on CUDA unless device='cpu' is passed; a mesh raises
NotImplementedError (one card).
"""

from __future__ import annotations

import asyncio
import sys
import traceback
from functools import partial
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..config import resolve_device
from ..parallel.batch import _not_ported
from .executor import call_in_loop, prune_progress, record_failure


class OnlineBatchingExecutor:
    """Drop-in Executor that coalesces live same-bucket jobs into batches
    of lanes (the reference's 2-at-a-time semaphore, re-imagined for a
    device that prefers one big batch over interleaved small jobs)."""

    def __init__(self, config, report_progress=None, engine=None,
                 verbose: bool = True, metrics=None, params=None,
                 mesh=None, max_batch: Optional[int] = 8,
                 report_failure=None,
                 batch_window_s: float = 0.25,
                 canonicalize: bool = True,
                 batch_policy: str = "auto",
                 pad_batches: bool = True,
                 retries: int = 0,
                 retry_delay_s: float = 25.0,
                 stream_images: bool = True,
                 queue_runner: Optional[Callable] = None,
                 batch_join: bool = True,
                 device=None):
        # `engine` is accepted for signature parity with Executor; the
        # unit of execution here is the batched queue (tests inject
        # `queue_runner` instead)
        del engine
        _not_ported(mesh, False)
        self.device = resolve_device(device)
        self.__config = config
        self.__report_progress = report_progress
        self.__report_failure = report_failure
        self.__verbose = verbose
        self.metrics = metrics
        self.params = params
        self.mesh = mesh
        # default 8: bounds both the padded-size ladder {1, 2, 4, 8} (one
        # captured graph each, what the serving warmup captures) and the
        # global lane budget of the live path
        self.max_batch = max_batch
        self.batch_window_s = batch_window_s
        self.canonicalize = canonicalize
        self.batch_policy = batch_policy
        self.pad_batches = pad_batches
        # re-run a failed round's (or live bucket's) jobs, each attempt
        # retry_delay_s after the failure (run_job_queue's default)
        self.retries = retries
        self.retry_delay_s = retry_delay_s
        # stream_images=False: intermediate progress carries images=None
        # (final images are still delivered)
        self.stream_images = stream_images
        self.queue_runner = queue_runner  # injectable (tests)
        self.batch_join = batch_join
        self._runners: Dict[tuple, Any] = {}  # bucket -> LiveBatchRunner
        self.__progress: Dict[str, tuple] = {}
        self.__progress_lock = asyncio.Lock()
        self.__pending: List[Tuple[str, np.ndarray, np.ndarray]] = []
        self.__pending_lock = asyncio.Lock()
        self.__wake: Optional[asyncio.Event] = None
        self.__idle: Optional[asyncio.Event] = None
        self.__dispatcher: Optional[asyncio.Task] = None
        self.__busy = False
        self.__round_ids: frozenset = frozenset()  # tasks in flight
        # live retries waiting out retry_delay_s: asyncio task -> the
        # tasks it puts back in the pending list
        self.__delayed: Dict[asyncio.Task, list] = {}
        self.failures: Dict[str, BaseException] = {}
        self.dispatch_rounds = 0  # observability: rounds actually run

    # -- progress table (same copy-on-read contract as Executor) ----------

    async def get_progress(self, key):
        async with self.__progress_lock:
            value = self.__progress[key]
            return (value[0],
                    value[1].copy() if value[1] is not None else None)

    async def progress(self):
        async with self.__progress_lock:
            for pr in self.__progress.items():
                yield pr

    async def task_ids(self):
        async with self.__progress_lock:
            return list(self.__progress.keys())

    async def set_progress(self, key, value):
        async with self.__progress_lock:
            self.__progress[key] = (
                value[0], value[1].copy() if value[1] is not None else None)
            # live = queued + in-flight tasks, plus the entry being
            # written (add_task seeds progress before queuing); read
            # without the pending lock: no await between read and use,
            # and only an eviction heuristic
            live = {tid for tid, _c, _s in self.__pending}
            live.update(self.__round_ids)
            live.update(tid for tasks in self.__delayed.values()
                        for tid, _c, _s in tasks)
            live.add(key)
            prune_progress(self.__progress, self.failures, live)

    # -- task intake -------------------------------------------------------

    async def add_task(self, task_id: str, content_n_style):
        """Queue a job; same-bucket jobs pending at dispatch time run as
        one batch. Canonicalization (aspect-bucket crop + resize) happens
        here so bucketing and the warmup shapes agree."""
        content = np.asarray(content_n_style.content[1])
        style = np.asarray(content_n_style.style[1])
        if self.canonicalize:
            from ..parallel.batch import (canonicalize_content,
                                          canonicalize_style)

            # the resize of a large photo is CPU-bound: keep it off the
            # event loop
            loop = asyncio.get_running_loop()
            content, style = await loop.run_in_executor(
                None, lambda: (canonicalize_content(content, self.__config),
                               canonicalize_style(style, self.__config)))
        await self.set_progress(task_id, (-1, None))
        if self.metrics is not None:
            self.metrics.log("task_added", task=task_id)
        async with self.__pending_lock:
            self.__pending.append((task_id, content, style))
        self._ensure_dispatcher()
        self.__idle.clear()
        self.__wake.set()
        if self.__verbose:
            print(f"Task {task_id} queued (online batching)")

    # -- dispatch ----------------------------------------------------------

    def _ensure_dispatcher(self):
        loop = asyncio.get_running_loop()
        if self.__dispatcher is None or self.__dispatcher.done() \
                or getattr(self, "_loop", None) is not loop:
            # (re)create per event loop; a round interrupted by the
            # previous loop's teardown never ran its `finally`, so clear
            # the busy flag too
            self._loop = loop
            self.__busy = False
            self.__wake = asyncio.Event()
            # set while nothing is pending and nothing is in flight
            self.__idle = asyncio.Event()
            self.__idle.set()
            self.__dispatcher = loop.create_task(self._dispatch_loop())
            if self.__pending:
                # jobs queued under the previous loop
                self.__idle.clear()
                self.__wake.set()

    async def _dispatch_loop(self):
        while True:
            await self.__wake.wait()
            self.__wake.clear()
            # coalescing window: near-simultaneous requests join the round
            if self.batch_window_s > 0:
                await asyncio.sleep(self.batch_window_s)
            async with self.__pending_lock:
                jobs, self.__pending = self.__pending, []
            if not jobs:
                # spurious wake: still drained, signal it
                if not self.__wake.is_set():
                    self.__idle.set()
                continue
            self.__busy = True
            self.__round_ids = frozenset(tid for tid, _c, _s in jobs)
            try:
                if self._use_live():
                    await self._run_live(jobs)
                else:
                    await self._run_round(jobs)
            except Exception as e:  # noqa: BLE001 — keep serving
                for tid, _c, _s in jobs:
                    await self._record_failure(tid, e)
            finally:
                self.__busy = False
                self.__round_ids = frozenset()
                # signal drained-ness to run(); an interleaved add_task
                # either set __wake first (seen here) or clears __idle
                # right after, and run() re-verifies under the lock
                async with self.__pending_lock:
                    empty = not self.__pending
                if empty and not self.__wake.is_set():
                    self.__idle.set()

    async def _run_round(self, jobs):
        from ..parallel.batch import run_job_queue

        runner = self.queue_runner or run_job_queue
        loop = asyncio.get_running_loop()
        self.dispatch_rounds += 1
        if self.__verbose:
            print(f"online batch round: {len(jobs)} job(s)")

        def progress_cb(tid, pct, img, loss):
            # called from the worker thread: hop back into the loop
            try:
                call_in_loop(loop, self._report(tid, pct, img, loss))
            except Exception:  # noqa: BLE001
                # one user's report hook failing must not fail the whole
                # batch: log and keep optimizing
                traceback.print_exc()

        results, failures = await loop.run_in_executor(
            None, partial(
                runner, jobs, self.__config, params=self.params,
                mesh=self.mesh, progress=progress_cb,
                batch_policy=self.batch_policy, max_batch=self.max_batch,
                pad_batches=self.pad_batches, retries=self.retries,
                retry_delay_s=self.retry_delay_s,
                stream_images=self.stream_images,
                # shapes were canonicalized at add_task
                canonicalize_styles=False, canonicalize_contents=False,
                device=self.device))
        for tid in results:
            if self.metrics is not None:
                self.metrics.log("task_done", task=tid)
            if self.__verbose:
                print(f"Task {tid} done")
        for tid, exc in failures.items():
            await self._record_failure(tid, exc)

    def _use_live(self):
        """Chunk-boundary joins engage on the 'batched' policy routes
        (resolve_batch_policy); sequential-policy configs (lr-opening
        full-Wolfe L-BFGS) and injected queue_runners keep the round
        path."""
        if not self.batch_join or self.queue_runner is not None:
            return False
        from ..parallel.batch import resolve_batch_policy

        return resolve_batch_policy(self.__config,
                                    self.batch_policy) == "batched"

    async def _run_live(self, jobs):
        """Serve through per-bucket LiveBatchRunners until drained.

        One chunk per active runner per cycle, round-robin over buckets.
        Between chunks the pending list is drained again, so tasks that
        arrived during a chunk join their bucket's batch at the very next
        boundary (or start a new bucket's runner). A runner whose step
        raises gives back its tasks: each is resubmitted fresh,
        retry_delay_s later, while it has retries left (self.retries),
        else its failure is recorded; other buckets run on meanwhile, and
        with nothing else to run the drive waits for the resubmission or
        a new arrival.

        Global lane budget: concurrent runners hold their batch states on
        the card at once, so jobs enter runners first in, first out only
        while the total reserved (padded) lanes stay within max_batch;
        the overflow waits in the pending list and flows in as lanes free
        up.

        An error outside a chunk (intake, a report hook) fails every task
        this drive holds, in runners or requeued, and drops the runners."""
        from ..parallel.live import LiveBatchRunner

        loop = asyncio.get_running_loop()
        self.dispatch_rounds += 1
        lane_budget = max(1, self.max_batch or 8)
        # tasks this drive took from the pending list that have neither
        # finished nor failed (insertion-ordered)
        held: Dict[str, None] = dict.fromkeys(tid for tid, _c, _s in jobs)
        attempts: Dict[str, int] = {}

        def feed(batch_jobs):
            """Admit jobs up to the global lane budget; returns deferred."""
            used = sum(r.lanes_reserved for r in self._runners.values())
            deferred = []
            for i, (tid, content, style) in enumerate(batch_jobs):
                if used >= lane_budget:
                    deferred = batch_jobs[i:]
                    break
                key = (content.shape, style.shape)
                runner = self._runners.get(key)
                if runner is None:
                    runner = self._runners[key] = LiveBatchRunner(
                        self.__config, params=self.params,
                        max_batch=self.max_batch,
                        stream_images=self.stream_images,
                        device=self.device)
                before = runner.lanes_reserved
                runner.submit(tid, content, style)
                used += runner.lanes_reserved - before
            return deferred

        async def requeue(deferred):
            if deferred:
                async with self.__pending_lock:
                    self.__pending = deferred + self.__pending

        try:
            await requeue(feed(jobs))
            rr = 0  # round-robin cursor over buckets
            while True:
                # mid-flight arrivals, deferred and retried jobs: drain
                # and feed at every chunk boundary
                async with self.__pending_lock:
                    fresh, self.__pending = self.__pending, []
                if fresh:
                    held.update(dict.fromkeys(t for t, _c, _s in fresh))
                    await requeue(feed(fresh))
                active = [(key, r) for key, r in self._runners.items()
                          if r.active]
                if not active:
                    async with self.__pending_lock:
                        drained = not self.__pending
                    if drained and not self.__delayed:
                        break
                    if drained:
                        # only delayed retries are left: wait for one of
                        # them, or a new arrival, to fill the pending list
                        await self.__wake.wait()
                        self.__wake.clear()
                    continue
                self.__round_ids = frozenset(
                    tid for _k, r in active for tid in r.all_tids)
                key, runner = active[rr % len(active)]
                rr += 1
                try:
                    report = await loop.run_in_executor(None, runner.step)
                except Exception as e:  # noqa: BLE001 — bucket isolation
                    del self._runners[key]
                    self._requeue_later(await self._retry_or_fail(
                        runner.take_all(), attempts, held, e))
                    continue
                for tid in report.joined:
                    if self.metrics is not None:
                        self.metrics.log("task_joined", task=tid,
                                         batch=report.batch)
                    if self.__verbose:
                        print(f"Task {tid} joined live batch "
                              f"(size {report.batch})")
                for tid, pct, img, loss in report.progress:
                    await self._report(tid, pct, img, loss)
                for tid in report.finished:
                    held.pop(tid, None)
                    if self.metrics is not None:
                        self.metrics.log("task_done", task=tid)
                    if self.__verbose:
                        print(f"Task {tid} done")
        except Exception as e:  # noqa: BLE001 — keep serving
            traceback.print_exc()
            self._cancel_delayed()
            for runner in self._runners.values():
                runner.take_all()
            self._runners.clear()
            async with self.__pending_lock:
                self.__pending = [j for j in self.__pending
                                  if j[0] not in held]
            for tid in list(held):
                await self._record_failure(tid, e)

    async def _retry_or_fail(self, tasks, attempts, held, exc):
        """The tasks of a failed runner that have retries left (to
        resubmit fresh); the failures of the others are recorded."""
        retry = []
        for task in tasks:
            tid = task[0]
            if attempts.get(tid, 0) < self.retries:
                attempts[tid] = attempts.get(tid, 0) + 1
                retry.append(task)
            else:
                held.pop(tid, None)
                await self._record_failure(tid, exc)
        if retry:
            print(f"online: live bucket failed ({type(exc).__name__}: "
                  f"{exc}); resubmitting {len(retry)} task(s) in "
                  f"{self.retry_delay_s:g} s", file=sys.stderr)
        return retry

    def _requeue_later(self, tasks):
        """Put a failed bucket's retried tasks back in the pending list
        retry_delay_s from now, without holding up the dispatch loop."""
        if not tasks:
            return

        async def requeue():
            await asyncio.sleep(self.retry_delay_s)
            async with self.__pending_lock:
                self.__pending.extend(tasks)
                self.__delayed.pop(waiter, None)
            self.__wake.set()

        waiter = asyncio.get_running_loop().create_task(requeue())
        self.__delayed[waiter] = tasks

    def _cancel_delayed(self):
        """Cancel the waiting live retries; returns their asyncio tasks."""
        waiters = list(self.__delayed)
        for waiter in waiters:
            waiter.cancel()
        self.__delayed.clear()
        return waiters

    async def _report(self, tid, pct, img, loss):
        await self.set_progress(tid, (pct, img))
        if self.metrics is not None:
            self.metrics.log("progress", task=tid, percent=pct, loss=loss)
        if self.__report_progress is not None:
            await self.__report_progress(tid, (pct, img))

    async def _record_failure(self, tid, exc):
        record_failure(
            self.failures, tid, exc,
            (lambda event, task_id: self.metrics.log(event, task=task_id))
            if self.metrics is not None else None)
        if self.__report_failure is not None:
            try:
                await self.__report_failure(tid, exc)
            except Exception:  # noqa: BLE001 — best-effort notification
                traceback.print_exc()

    # -- lifecycle ---------------------------------------------------------

    async def aclose(self):
        """Cancel the dispatcher task cleanly (harnesses and short-lived
        embedders; the serving frontends keep dispatching for the process
        lifetime). Queued but unstarted jobs are dropped, and so are live
        retries still waiting out retry_delay_s; call run() first to
        drain."""
        await asyncio.gather(*self._cancel_delayed(), return_exceptions=True)
        if self.__dispatcher is not None and not self.__dispatcher.done():
            self.__dispatcher.cancel()
            try:
                await self.__dispatcher
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass
        self.__dispatcher = None

    async def run(self, forever: bool = False):
        """Wait until every queued job has been dispatched and finished;
        with forever=True keep serving (Executor.run's contract). Waits on
        the dispatcher's drained signal; forever mode keeps a slow
        keep-alive tick only."""
        self._ensure_dispatcher()
        while True:
            await self.__idle.wait()
            # re-verify: the signal may be stale across an interleaved
            # add_task or an event-loop re-bind
            async with self.__pending_lock:
                drained = not self.__pending
            if drained and not self.__busy and not self.__wake.is_set():
                if not forever:
                    return
                await asyncio.sleep(1.0)  # keep-alive; not a latency path
            else:
                # woken stale: the dispatcher re-signals when drained
                self.__idle.clear()
