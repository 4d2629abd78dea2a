"""Asyncio task executor: concurrent style-transfer jobs with streamed progress.

A port of the JAX package's ``runtime/executor.py`` (reference
task_executor.py:13-129), wired to this package's engine:
- Task spawns its job on construction; the job acquires a global semaphore
  capping concurrency at config.simultaneous_tasks_count, iterates the
  engine's async generator, defensively copies each result, and reports it.
- Executor keeps task and progress tables behind asyncio locks; progress
  entries are (percent, latest image) tuples seeded with (-1, None).
- run(forever=False) waits for all live jobs; run(forever=True) keeps
  polling for new ones with a non-blocking asyncio.sleep.

Jobs run on CUDA unless the Executor is given device='cpu'; without a card
the Executor raises at construction. The engine function is injectable
(it receives the device as a keyword) so tests can use a fake engine.
"""

from __future__ import annotations

import asyncio
import sys
import traceback
from typing import Callable, Dict, Optional

from .. import config as config_mod
from ..config import resolve_device
from ..engine.transfer import ContentStylePair, neural_style_transfer

_semaphore: Optional[asyncio.Semaphore] = None
_semaphore_loop: Optional[asyncio.AbstractEventLoop] = None

# Failure-table retention cap: a long-lived serving process (the Telegram
# bot runs forever) must not grow Executor.failures without bound; the
# oldest entries age out once frontends have had ample time to render them.
MAX_RECORDED_FAILURES = 256


def record_failure(failures: dict, task_id: str, error: BaseException,
                   log_metric=None) -> None:
    """Record a task failure under the shared retention cap (oldest entries
    age out so a long-lived serving process cannot grow the table without
    bound). Every failure write goes through here so the cap is enforced
    in one place."""
    failures[task_id] = error
    while len(failures) > MAX_RECORDED_FAILURES:
        # dicts iterate in insertion order: drop the oldest
        failures.pop(next(iter(failures)))
    print(f"Task {task_id} FAILED: {type(error).__name__}: {error}",
          file=sys.stderr)
    if log_metric is not None:
        log_metric("task_failed", task_id)


# Progress-table retention cap: like the failure table, a forever-serving
# process (the Telegram bot) must not accumulate one full-resolution final
# image per completed task. Only TERMINAL entries (done or failed) are
# evicted; a running task's progress is never dropped.
MAX_PROGRESS_ENTRIES = 1024


def prune_progress(progress: dict, failures: dict, live=None) -> None:
    """Evict the oldest terminal progress entries once over the cap (dicts
    iterate in insertion order). Caller must hold the progress lock.

    Terminal = done (>= 100), recorded failed, or — when the caller
    supplies its `live` task-id set — no longer live at all. The liveness
    rule matters because the failure table has its own retention cap
    (MAX_RECORDED_FAILURES): a failed task whose failure record has aged
    out would otherwise hold its last streamed image in the progress
    table forever."""
    if len(progress) <= MAX_PROGRESS_ENTRIES:
        return
    # live=None means "caller has no liveness info": evict only entries
    # that are provably terminal by their own state
    know_live = live is not None
    live = set(live) if know_live else set()
    for key in list(progress):
        if len(progress) <= MAX_PROGRESS_ENTRIES:
            break
        if key in live:
            continue
        if progress[key][0] >= 100 or key in failures or know_live:
            progress.pop(key)


def call_in_loop(loop, coro, timeout_s: float = 60.0) -> bool:
    """Run `coro` on `loop` from a worker thread and wait, bounded.

    The thread-to-loop progress hop of batched queue callbacks (the online
    executor reports from the run_in_executor worker that drives the
    card). Returns False, dropping the update, when the loop is shutting
    down: a loop that is stopped but not yet closed never runs the
    coroutine, and an unbounded result() would hang the worker thread at
    interpreter exit. Any other failure propagates to the caller."""
    from concurrent.futures import TimeoutError as FuturesTimeout

    try:
        fut = asyncio.run_coroutine_threadsafe(coro, loop)
    except RuntimeError:
        coro.close()  # never scheduled: suppress the un-awaited warning
        return False
    try:
        fut.result(timeout=timeout_s)
    except (RuntimeError, FuturesTimeout):
        return False
    return True


def _get_semaphore() -> asyncio.Semaphore:
    """Global concurrency cap (reference task_executor.py:9), created lazily
    and re-bound whenever the running event loop changes: a semaphore created
    under one `asyncio.run()` holds waiters from that (dead) loop, so a
    second run in the same process (CLI invoked twice programmatically, lab
    after a CLI warmup) must get a fresh one."""
    global _semaphore, _semaphore_loop
    loop = asyncio.get_running_loop()
    if _semaphore is None or _semaphore_loop is not loop:
        _semaphore = asyncio.Semaphore(config_mod.simultaneous_tasks_count)
        _semaphore_loop = loop
    return _semaphore


def reset_semaphore() -> None:
    """Recreate the global semaphore (e.g. after changing the cap; a new
    event loop re-binds automatically)."""
    global _semaphore, _semaphore_loop
    _semaphore = None
    _semaphore_loop = None


class Task:
    """A single optimization task reporting its output to the Executor
    (reference task_executor.py:13-42)."""

    def __init__(self, content_n_style: ContentStylePair, config,
                 task_id: str, report: Callable, job_done: Callable,
                 engine=None, device=None):
        self.__task_id = task_id
        self.__report = report
        self.__job_done_callback = job_done
        self.__content_n_style = content_n_style
        self.__config = config
        self.__engine = engine or neural_style_transfer
        self.__device = device
        self.job = asyncio.create_task(self.__do_job())

    async def __do_job(self):
        cfg = self.__config
        error = None
        try:
            async with _get_semaphore():
                # the 14 positional fields are the reference engine API
                # (reference task_executor.py:30-33); config carries the
                # FULL executor config through — without it the engine
                # rebuilds Config() from the positionals alone and every
                # other knob silently resets to its default
                async for result in self.__engine(
                        self.__content_n_style,
                        cfg.content_weight, cfg.style_weight, cfg.tv_weight,
                        cfg.optimizer, cfg.model, cfg.init_method,
                        cfg.iters_num, cfg.levels_num, cfg.noise_factor,
                        cfg.noise_levels, cfg.noise_levels_central_amplitude,
                        cfg.noise_levels_peripheral_amplitude,
                        cfg.noise_levels_dispersion,
                        config=cfg, device=self.__device):
                    result_copy = (result[0],
                                   result[1].copy() if result[1] is not None
                                   else None)
                    await self.__report(self.__task_id, result_copy)
        except Exception as e:  # noqa: BLE001 — recorded, not swallowed
            error = e
            traceback.print_exc()
        finally:
            # Always fire job_done: the reference leaks failed tasks
            # (SURVEY §5 — "a failed task stays in tasks_table forever");
            # here a raised job is still removed so Executor.run() cannot
            # wait on it indefinitely, and the exception is recorded in
            # Executor.failures for the frontends.
            await self.__job_done_callback(self.__task_id, error)


class Executor:
    """Executes optimization tasks and collects results
    (reference task_executor.py:45-129)."""

    def __init__(self, config, report_progress=None, engine=None,
                 verbose: bool = True, metrics=None, report_failure=None,
                 device=None):
        self.device = resolve_device(device)
        self.__tasks: Dict[str, Task] = {}
        self.__progress: Dict[str, tuple] = {}
        self.__config = config
        self.__progress_lock = asyncio.Lock()
        self.__tasks_lock = asyncio.Lock()
        self.__report_progress = report_progress
        # optional async (task_id, exception) hook: a serving frontend can
        # tell the user their job died (the reference leaves the chat
        # waiting forever — SURVEY §5 failure handling)
        self.__report_failure = report_failure
        self.__engine = engine
        self.__verbose = verbose
        self.failures: Dict[str, BaseException] = {}
        # optional utils.metrics.MetricsLogger: structured per-progress JSONL
        # events (in place of the reference's per-iteration prints,
        # reference neural_style_transfer.py:159,189,196)
        self.metrics = metrics

    async def get_progress(self, key):
        async with self.__progress_lock:
            value = self.__progress[key]
            return (value[0], value[1].copy() if value[1] is not None else None)

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
            # live = tasks still registered, plus the entry being written
            # (add_task seeds progress BEFORE registering the Task). Plain
            # dict-keys read without the tasks lock: safe in asyncio (no
            # await between read and use) and only an eviction heuristic.
            live = set(self.__tasks)
            live.add(key)
            prune_progress(self.__progress, self.failures, live)

    async def __print_progress(self):
        if not self.__verbose:
            return
        async for task_id, p in self.progress():
            print(f"Progress: {task_id}, {p[0]}")
        print()

    def _log_metric(self, event: str, task_id: str, percent=None):
        if self.metrics is None:
            return
        fields = {"task": task_id}
        if percent is not None and percent >= 0:
            fields["percent"] = percent
        self.metrics.log(event, **fields)

    async def __report(self, task_id, result):
        await self.set_progress(task_id, result)
        await self.__print_progress()
        self._log_metric("progress", task_id, percent=result[0])
        if self.__report_progress is not None:
            await self.__report_progress(task_id, result)

    async def __job_done(self, task_id, error=None):
        async with self.__tasks_lock:
            if error is not None:
                record_failure(self.failures, task_id, error,
                               self._log_metric)
            else:
                if self.__verbose:
                    print(f"Task {task_id} done")
                self._log_metric("task_done", task_id)
            self.__tasks.pop(task_id)
        if error is not None and self.__report_failure is not None:
            # outside the lock: the hook may take the frontend's own locks
            try:
                await self.__report_failure(task_id, error)
            except Exception:  # noqa: BLE001 — best-effort notification
                traceback.print_exc()

    async def add_task(self, task_id: str, content_n_style: ContentStylePair):
        await self.set_progress(task_id, (-1, None))
        self._log_metric("task_added", task_id)
        async with self.__tasks_lock:
            self.__tasks[task_id] = Task(
                content_n_style, self.__config, task_id=task_id,
                report=self.__report, job_done=self.__job_done,
                engine=self.__engine, device=self.device)
            if self.__verbose:
                print(f"Task {task_id} run")
            return self.__tasks[task_id].job

    async def run(self, forever: bool = False):
        """Wait for all live jobs; with forever=True keep polling for new
        ones (reference task_executor.py:116-129, minus the blocking sleep).

        Failed jobs are recorded in .failures (task_id -> exception) and
        logged instead of being silently dropped."""
        while True:
            while True:
                async with self.__tasks_lock:
                    jobs = {task.job for task in self.__tasks.values()}
                if not jobs:
                    break
                await asyncio.wait(jobs)
            if not forever:
                return
            await asyncio.sleep(1)
