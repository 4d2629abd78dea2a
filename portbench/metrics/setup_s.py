"""setup_s: process start to the window's opening (host clock): imports,
kernel builds where the checkout has none yet, weights and images,
warm-up and capture, and a served cell's pre-fill."""


def read(r):
    return r.record.t_open - r.record.t_start
