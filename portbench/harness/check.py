"""How ``correct`` is decided: the program's answers against the plain
reference.

From the jobs whose answers were due in the window, the check draws a
sample by the run's seed (``jobs`` of them, every one in a queue that has
fewer) and, once the window has closed and the program's state is freed,
the reference (``portbench/reference``: float32, TF32 off) works each of
them out again from its raw images and the benchmark's weights: its
input pyramids, targets and initial image, then the same number of
optimizer steps as the program's first delivered report of that job.
The numbers compared, each the worst over the sample (eval_spread and
eval_bias: over all of the sample's images at once):

- ``loss_gap``: |the loss the program reported with that chunk - the
  reference's at the same step| / the reference's (entries that report
  a loss);
- ``eval_spread``: the standard deviation, over every image the sampled
  jobs delivered in the window, of the signed relative evaluation gap
  (the loss the program reported with the image - the reference's loss
  at that image) / the latter (L-BFGS reports the loss at the image it
  delivers): the evaluation's error at points both sides evaluate, free
  of the trajectory. A run's gaps share one offset, which a set of
  weights gives the whole objective in a precision (the same for every
  job and image of the run, its sign and size varying from seed to seed;
  ``eval_bias``, |their median|, prints it); the spread about it is what
  the precision does image by image;
- ``image_gap``: |program's image - reference's image| / |reference's
  image - initial image| (entries that deliver images);
- ``loss_shortfall``: (reference's loss at the program's image - at its
  own) / (reference's loss at the initial image - at its own): the
  share of the reference's progress the program's image misses.

Each cell's file names the numbers it holds to limits and the limits;
the others are printed. A sampled job that never answered fails the
check.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from .record import Job, RunRecord


def sample(record: RunRecord, count: int, seed: int) -> List[Job]:
    """`count` of the checked jobs (all of them if fewer), drawn from the
    run's seed, in traffic order."""
    jobs = [record.jobs[t] for t in record.checked]
    if len(jobs) <= count:
        return jobs
    rng = np.random.default_rng([int(seed), 1])
    pick = sorted(rng.choice(len(jobs), size=count, replace=False))
    return [jobs[i] for i in pick]


def job_numbers(job: Job, fields: Dict, weights, device, t_close: float
                ) -> Tuple[Dict[str, float], List[float]]:
    """The job's numbers, and its images' signed relative evaluation
    gaps."""
    import torch

    from portbench.reference import images
    from portbench.reference.model import Objective
    from portbench.reference.optim import retrace

    rep = job.first()
    images.check_canonical(job.content, job.style, fields)
    obj = Objective(job.content, job.style, fields, weights, device)
    init = images.init_image(job.content, job.style, fields, job.noise_seed)
    x0 = torch.from_numpy(images.prepare(init).reshape(1, -1)).to(device)
    ref = retrace(obj, x0, fields, rep.done)
    xr = ref["x"]

    def loss_at(img):
        x = torch.from_numpy(images.prepare(img).reshape(1, -1)).to(device)
        return x, float(obj.loss(x)[0])

    out: Dict[str, float] = {}
    with torch.no_grad():
        l0 = float(obj.loss(x0)[0])
        lr = float(obj.loss(xr)[0])
        if rep.loss is not None:
            out["loss_gap"] = abs(rep.loss - ref["f_chunk"]) / abs(
                ref["f_chunk"])
        if rep.image is not None:
            xp, lp = loss_at(rep.image)
            out["image_gap"] = float((xp - xr).norm() / (xr - x0).norm())
            out["loss_shortfall"] = (lp - lr) / (l0 - lr)
        gaps = []
        if fields["optimizer"] == "lbfgs":
            # every image the job delivered in the window (and its first),
            # each with the loss the program reported at it
            for r in job.reports:
                if (r.image is not None and r.loss is not None
                        and (r is rep or r.t <= t_close)):
                    lx = loss_at(r.image)[1]
                    gaps.append((r.loss - lx) / lx)
    out["ref_evals"] = float(ref["evals"])
    return out, gaps


def run_check(record: RunRecord, fields: Dict, params, limits: Dict,
              count: int, seed: int, device) -> Tuple[bool, Dict, List]:
    """(correct, {number: (worst value, limit or None)}, per-job rows)."""
    from portbench.reference.model import full_float32, weights_from_hwio

    picked = sample(record, count, seed)
    rows, worst, gaps = [], {}, []
    missing = [j.tid for j in picked if j.first() is None]
    weights = weights_from_hwio(params, device)
    with full_float32():
        for job in picked:
            if job.first() is None:
                continue
            nums, job_gaps = job_numbers(job, fields, weights, device,
                                         record.t_close)
            gaps += job_gaps
            rows.append({"job": job.tid, "step": job.first().done,
                         "images": len(job_gaps), **nums,
                         "gap_median": (float(np.median(job_gaps))
                                        if job_gaps else None),
                         "gap_spread": (float(np.std(job_gaps))
                                        if job_gaps else None)})
            for k, v in nums.items():
                if k != "ref_evals":
                    worst[k] = max(worst.get(k, -np.inf), v)
    if gaps:
        worst["eval_bias"] = abs(float(np.median(gaps)))
        worst["eval_spread"] = float(np.std(gaps))
    table = {k: (v, limits.get(k)) for k, v in sorted(worst.items())}
    held = [k for k in limits]
    correct = (not missing and bool(rows)
               and all(k in worst and np.isfinite(worst[k])
                       and worst[k] <= limits[k] for k in held))
    if missing:
        table["jobs_without_answer"] = (float(len(missing)), 0.0)
    return correct, table, rows
