"""device_idle_share: 1 - (the union of the device's operation intervals)
/ (the traced window), on the profiler's clock, as a share."""


def read(r):
    if r.trace is None or r.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
