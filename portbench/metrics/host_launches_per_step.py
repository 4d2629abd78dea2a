"""host_launches_per_step: the host's runtime calls that launched device
work in the window (cudaLaunchKernel and its kin; a CUDA graph launch
counts once), from the profiler, over the window's job-steps."""


def read(r):
    if r.trace is None or not r.trace.runtime_calls:
        return None
    steps = r.record.steps_between(r.record.t_open, r.record.t_close)
    return r.trace.host_launches / steps if steps else None
