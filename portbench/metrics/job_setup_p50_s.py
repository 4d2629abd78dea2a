"""job_setup_p50_s: the median set-up of a job, in seconds: the length of
each of the program's ``queue.job_setup`` spans (a BatchedTransferJob
built through its optimizer's init, up to its first chunk) that ends
inside the traced window. Read from the program's spans alone."""

from __future__ import annotations

from portbench.metrics.admit_wait_p50_s import median_of
from portbench.metrics.held_idle_share import program_spans


def read(r):
    spans = program_spans()
    if r.trace is None or not spans:
        return None
    return median_of(r.trace, spans, "queue.job_setup")
