"""gram_roofline: the least time of the Gram forward and backward calls
the window's evaluations ran (yardstick/counts.py: F read once
and G written once forward; F and G's gradient read and dF written once
backward), over the device time of the port's Gram kernels
(gram_partial_kernel, gram_reduce_kernel, gram_bwd_kernel)."""

KERNELS = ("gram_partial_kernel", "gram_reduce_kernel", "gram_bwd_kernel")


def read(r):
    if r.trace is None:
        return None
    secs, count = r.trace.device_seconds(
        lambda name: any(k in name for k in KERNELS))
    evals = r.lane_evals(r.record.launches_window)
    if not count or not evals:
        return None
    return 100.0 * evals * r.least(r.evaluation["gram_calls"]) / secs
