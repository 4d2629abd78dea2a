"""lbfgs_evals_per_step: loss-and-gradient evaluations per optimizer
step over the window, from the program's kernel-launch counters: one TV
forward launch per pyramid level and evaluation round (two with
remat_levels), each round evaluating every lane of the traffic's batch
(one lane where the traffic names none)."""


def read(r):
    if r.fields["optimizer"] != "lbfgs":
        return None
    steps = r.record.steps_between(r.record.t_open, r.record.t_close)
    evals = r.lane_evals(r.record.launches_window)
    return evals / steps if steps and evals else None
