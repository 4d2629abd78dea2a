"""One user's closed loop through the served path.

``OnlineBatchingExecutor`` is built as the online entry builds it (as the
web lab and the Telegram bot do), and one user sends a job, waits for
its final image, and sends the next: no two jobs ever share the card, so
whatever the executor does to batch or join concurrent jobs is bypassed,
and what is left is one job's own steps and its own set-up between jobs
(pyramids, targets, initial image). Set-up warms the executor's one-job
evaluation of the traffic's aspect bucket and nothing else.

Traffic keys: aspect, max_jobs (how many jobs the loop may need),
max_batch.
"""

from __future__ import annotations

import asyncio
import concurrent.futures

from portbench.harness.entry import (LATE_S, Context, attach_losses, drain,
                                     make_jobs, progress_hook, quiet_loop,
                                     wait_first_images)
from portbench.harness.record import RunRecord, now


def run(ctx: Context) -> RunRecord:
    from artstyletransfer_tpu_torch.engine.warmup import (
        online_warmup_plan, warmup_aspect_buckets)

    t = ctx.traffic
    sizes, mesh = online_warmup_plan(ctx.cfg, None,
                                     max_batch=int(t["max_batch"]))
    warmup_aspect_buckets(ctx.cfg, params=ctx.params,
                          aspects=(float(t["aspect"]),), verbose=False,
                          batch_sizes=sizes, mesh=mesh, device=ctx.device)
    # a one-job round is a batch of one: its noise is seeded with cfg.seed
    jobs = make_jobs(ctx, int(t["max_jobs"]), lambda i: ctx.fields["seed"])
    return asyncio.run(_loop(ctx, jobs))


async def _loop(ctx: Context, jobs) -> RunRecord:
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
    iters = ctx.fields["iters_num"]
    started = []
    s.open()
    for job in jobs.values():
        if s.due():
            break
        job.due = job.added = now()
        started.append(job)
        await executor.add_task(job.tid, ContentStylePair(
            (job.tid, job.content), (job.tid, job.style)))
        while not s.due() and not (job.reports
                                   and job.reports[-1].done >= iters):
            if job.tid in executor.failures:
                break
            await asyncio.sleep(0.01)
    else:
        raise RuntimeError("the traffic's max_jobs ran out inside the window")
    s.close()
    await wait_first_images(started[-1:], s.t_close + LATE_S)
    stop[0] = True
    await executor.aclose()
    await drain(pool)
    attach_losses(jobs, ctx.recorder, iters)
    failed = {j.tid for j in started if j.first() is None}
    failed |= {tid for tid in executor.failures
               if tid in {j.tid for j in started}}
    return s.record(jobs, checked=[j.tid for j in started],
                    attempted=len(started), failed=len(failed))
