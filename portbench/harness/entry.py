"""What the traffic entries (``traffic/<entry>.py``) share.

An entry gets a ``Context``, drives the program's own entry point with
the cell's traffic, opens and closes the session's window, and returns a
``RunRecord``. It stops the program once the window has closed and the
jobs the check needs have delivered their first images.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import dataclasses
from typing import Any, Callable, Dict, List

import numpy as np

from . import inputs
from .record import Job, Recorder, Report, now
from .session import Session, WindowClosed

LATE_S = 60.0  # how long past the close the check waits for an answer


@dataclasses.dataclass
class Context:
    cfg: Any                  # the port's Config
    fields: Dict[str, Any]    # the same, as the configuration file's dict
    traffic: Dict[str, Any]
    params: Dict[str, Dict[str, np.ndarray]]
    seed: int
    device: str
    session: Session
    recorder: Recorder

    @property
    def content_side(self) -> int:
        return self.fields["base_diameter"] * 2 ** (
            self.fields["levels_num"] - 1)

    @property
    def style_side(self) -> int:
        return self.fields["base_diameter"]


def make_jobs(ctx: Context, count: int, noise_seed: Callable[[int], int]
              ) -> Dict[str, Job]:
    """count jobs with the run's seeded images, in traffic order; job i's
    initial image draws its noise from noise_seed(i), as the program
    seeds it on the entry this traffic takes."""
    jobs = {}
    for i in range(count):
        content, style = inputs.job_images(ctx.seed, i, ctx.content_side,
                                           ctx.style_side)
        tid = f"job{i:04d}"
        jobs[tid] = Job(tid=tid, index=i, content=content, style=style,
                        noise_seed=noise_seed(i))
    return jobs


def steps_of(ctx: Context, percent: float) -> int:
    return int(round(percent / 100.0 * ctx.fields["iters_num"]))


def attach_losses(jobs: Dict[str, Job], recorder: Recorder,
                  iters: int) -> None:
    """Give each report the loss the program logged with it (the served
    path logs ('progress', task, percent, loss) before it reports)."""
    logged = {}
    for e in recorder.of("progress"):
        if e.get("loss") is not None:
            done = int(round(float(e["percent"]) / 100.0 * iters))
            logged[(e["task"], done)] = float(e["loss"])
    for job in jobs.values():
        for rep in job.reports:
            rep.loss = logged.get((job.tid, rep.done), rep.loss)


def progress_hook(ctx: Context, jobs: Dict[str, Job], stop: List[bool]):
    """The executors' report_progress coroutine: records each delivery
    with its image; once stop[0] is set it ends the program's run
    (WindowClosed)."""

    async def hook(task_id, result):
        percent, img = result
        t = now()
        jobs[task_id].reports.append(Report(
            t, steps_of(ctx, percent),
            image=None if img is None else np.asarray(img, np.float32)))
        if stop[0]:
            raise WindowClosed()

    return hook


def quiet_loop(loop: asyncio.AbstractEventLoop) -> None:
    """Drop the loop's report of a task that ended with WindowClosed."""
    default = loop.get_exception_handler()

    def handler(lp, context):
        if isinstance(context.get("exception"), WindowClosed):
            return
        if default is not None:
            default(lp, context)
        else:
            lp.default_exception_handler(context)

    loop.set_exception_handler(handler)


async def open_for(session: Session) -> None:
    """Open the window and hold it for the session's seconds."""
    session.open()
    while not session.due():
        await asyncio.sleep(min(0.05, max(0.0, session.t_open
                                          + session.seconds - now())))
    session.close()


async def wait_first_images(jobs: List[Job], deadline: float) -> None:
    while any(j.first() is None for j in jobs) and now() < deadline:
        await asyncio.sleep(0.05)


async def drain(pool: concurrent.futures.ThreadPoolExecutor) -> None:
    """Wait until every thread of the loop's pool has ended (a thread
    running the program ends at its next delivery, once stopped)."""
    side = concurrent.futures.ThreadPoolExecutor(1)
    try:
        await asyncio.get_running_loop().run_in_executor(
            side, lambda: pool.shutdown(wait=True))
    finally:
        side.shutdown(wait=True)
