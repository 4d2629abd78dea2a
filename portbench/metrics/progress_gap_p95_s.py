"""progress_gap_p95_s: the 95th percentile, over every progress image
delivered inside the window, of the seconds since the same job's
previous image, or since the job was due for its first."""

from portbench.harness.record import percentile


def read(r):
    rec = r.record
    gaps = []
    for job in rec.jobs.values():
        if job.due is None:
            continue
        prev = job.due
        for rep in job.reports:
            if rec.t_open < rep.t <= rec.t_close:
                gaps.append(rep.t - prev)
            prev = rep.t
    return percentile(gaps, 95)
