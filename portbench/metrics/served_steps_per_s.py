"""served_steps_per_s: every optimizer step that every served job
completed inside the window, over the window's seconds (host clock).
Each delivered progress report counts the steps since its job's previous
report; gaps between jobs and every job's own set-up stay in the window.
Below the knee it reads the offered work: a guard against falling
behind, not a speed."""


def read(r):
    rec = r.record
    return rec.steps_between(rec.t_open, rec.t_close) / rec.window_s
