"""Open-loop arrivals served live: ``runtime/online.py``'s executor.

``OnlineBatchingExecutor`` is built as the web lab and the Telegram bot
build it (one card: no mesh; no retries), with the benchmark's weights.
Jobs arrive on a fixed schedule: ``rate`` jobs a second, the gaps the
quantiles (i + 1/2) / N of the exponential distribution put in an order
drawn from ``schedule_seed``, so every run offers the same arrivals and
only the images change with the run's seed. The first ``prefill_s``
seconds of arrivals fill the executor before the window opens. Each job
is timed from when it was due. Set-up warms the round sizes that this
configuration's executor dispatches on the traffic's aspect bucket
(``engine/warmup.py``'s plan) and nothing else.

Traffic keys: rate, prefill_s, schedule_seed, aspect, max_batch.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
from typing import List

import numpy as np

from portbench.harness.entry import (LATE_S, Context, attach_losses, drain,
                                     make_jobs, open_for, progress_hook,
                                     quiet_loop, wait_first_images)
from portbench.harness.record import RunRecord, now


def schedule(traffic: dict, seconds: float) -> List[float]:
    """Arrival offsets (s) from the schedule's start, up to the window's
    close, the same for every run seed: N = rate * span gaps, the
    exponential quantiles (i + 1/2) / N scaled to fill the span exactly,
    in an order drawn from schedule_seed: n arrivals in [0, span)."""
    rate = float(traffic["rate"])
    span = float(traffic["prefill_s"]) + float(seconds)
    n = max(1, int(round(span * rate)))
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n)
    gaps *= span / gaps.sum()
    gaps = np.random.default_rng(int(traffic["schedule_seed"])).permutation(
        gaps)
    return [0.0] + [float(t) for t in np.cumsum(gaps)[:-1]]


def run(ctx: Context) -> RunRecord:
    from artstyletransfer_tpu_torch.engine.warmup import (
        online_warmup_plan, warmup_aspect_buckets)

    t = ctx.traffic
    sizes, mesh = online_warmup_plan(ctx.cfg, None,
                                     max_batch=int(t["max_batch"]))
    warmup_aspect_buckets(ctx.cfg, params=ctx.params,
                          aspects=(float(t["aspect"]),), verbose=False,
                          batch_sizes=sizes, mesh=mesh, device=ctx.device)
    offsets = schedule(t, ctx.session.seconds)
    # the executor runs a one-job round as a batch of one: job i's noise
    # is seeded with cfg.seed (lane 0)
    jobs = make_jobs(ctx, len(offsets), lambda i: ctx.fields["seed"])
    return asyncio.run(_serve(ctx, jobs, offsets))


async def _serve(ctx: Context, jobs, offsets) -> RunRecord:
    from artstyletransfer_tpu_torch.engine.transfer import ContentStylePair
    from artstyletransfer_tpu_torch.runtime.online import (
        OnlineBatchingExecutor)

    loop = asyncio.get_running_loop()
    quiet_loop(loop)
    pool = concurrent.futures.ThreadPoolExecutor(4)
    loop.set_default_executor(pool)
    s = ctx.session
    stop = [False]
    executor = OnlineBatchingExecutor(
        ctx.cfg, report_progress=progress_hook(ctx, jobs, stop),
        verbose=False, metrics=ctx.recorder, params=ctx.params, mesh=None,
        max_batch=int(ctx.traffic["max_batch"]), retries=0,
        device=ctx.device)
    order = list(jobs.values())
    t0 = now() + 0.2

    async def arrive():
        for job, off in zip(order, offsets):
            delay = t0 + off - now()
            if delay > 0:
                await asyncio.sleep(delay)
            job.due, job.added = t0 + off, now()
            await executor.add_task(job.tid, ContentStylePair(
                (job.tid, job.content), (job.tid, job.style)))

    arrivals = loop.create_task(arrive())
    await asyncio.sleep(max(0.0, t0 + float(ctx.traffic["prefill_s"]) - now()))
    await open_for(s)
    arrivals.cancel()
    due = [j for j in order if j.due is not None
           and s.t_open <= j.due < s.t_close]
    await wait_first_images(due, s.t_close + LATE_S)
    stop[0] = True
    await executor.aclose()
    await drain(pool)
    try:
        await arrivals
    except (asyncio.CancelledError, Exception):  # noqa: BLE001 — stopped
        pass
    attach_losses(jobs, ctx.recorder, ctx.fields["iters_num"])
    late = [j.added - j.due for j in order if j.added is not None]
    failed = {j.tid for j in due if j.first() is None}
    failed |= {tid for tid in executor.failures if tid in {j.tid for j in due}}
    backlog = sum(1 for j in order if j.due is not None and j.due < s.t_close
                  and (j.first() is None or j.first().t > s.t_close))
    return s.record(jobs, checked=[j.tid for j in due], attempted=len(due),
                    failed=len(failed),
                    notes={"generator_late_max_s": max(late, default=0.0),
                           "arrivals": len(late),
                           "backlog_at_close": backlog})
