"""conv_roofline: the least time of the convolutions the window's
evaluations ran (each call's operations over the peak or its bytes over
the bandwidth, the larger; forward and input gradient), over the device
time of the convolution kernels there, by name. The targets' forward
passes at each job's set-up are not counted as work."""

CONV_WORDS = ("conv", "fprop", "dgrad", "wgrad", "implicit", "winograd",
              "fft", "cudnn")
OWN = ("gram", "tv_", "conv3x3_relu")


def is_conv(name):
    low = name.lower()
    return (any(w in low for w in CONV_WORDS)
            and not any(w in low for w in OWN) and "gemv" not in low)


def read(r):
    if r.trace is None:
        return None
    secs, count = r.trace.device_seconds(is_conv)
    evals = r.lane_evals(r.record.launches_window)
    if not count or not evals:
        return None
    return 100.0 * evals * r.least(r.evaluation["conv_calls"]) / secs
