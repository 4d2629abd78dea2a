"""step_mfu: the whole step's share of the peak while a job steps: the
operations of one evaluation (yardstick/counts.py: VGG19's convolutions
forward and input-gradient at every level, and the Grams) times the
steps of every chunk that began and ended inside the window (one job's
report to its next), over those chunks' seconds and the peak of the
configuration's precision (yardstick/peaks.py). One evaluation per step,
whatever the line search spends. A chunk's seconds are what a progress
gap is made of, so this bounds every kernel's share of a gap."""


def read(r):
    rec = r.record
    steps = seconds = 0.0
    for job in rec.jobs.values():
        for prev, rep in zip(job.reports, job.reports[1:]):
            if rec.t_open < prev.t and rep.t <= rec.t_close:
                steps += rep.done - prev.done
                seconds += rep.t - prev.t
    if not steps or seconds <= 0:
        return None
    return 100.0 * r.evaluation["ops"] * steps / seconds / r.peak_ops
