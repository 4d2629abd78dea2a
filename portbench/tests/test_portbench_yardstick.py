"""The yardstick's counts against hand counts, and the trace arithmetic
over a synthetic event list."""

import pytest

from portbench.harness.trace import TraceData
from portbench.yardstick import counts, peaks


def hand_conv_forward(h, w):
    """The 13 convs written out: 2 * pixels * 9 * c_in * c_out."""
    s = lambda k: (h >> k) * (w >> k)  # noqa: E731
    return 18 * (s(0) * (3 * 64 + 64 * 64)
                 + s(1) * (64 * 128 + 128 * 128)
                 + s(2) * (128 * 256 + 3 * 256 * 256)
                 + s(3) * (256 * 512 + 3 * 512 * 512)
                 + s(4) * 512 * 512)


@pytest.mark.parametrize("h,w", [(512, 512), (64, 96)])
def test_conv_counts(h, w):
    assert counts.conv_forward_ops(h, w) == hand_conv_forward(h, w)


def test_conv_forward_at_512_is_189_gflop():
    assert counts.conv_forward_ops(512, 512) == pytest.approx(189.35e9,
                                                              rel=1e-3)


@pytest.mark.parametrize("h,w", [(512, 512), (64, 96)])
def test_gram_counts(h, w):
    g = {c["name"]: c for c in counts.gram_calls(h, w)}
    n = (h // 4) * (w // 4)  # conv3_1: two pools
    assert g["conv3_1"]["fwd_ops"] == n * 256 * 257
    assert g["conv3_1"]["bwd_ops"] == 2 * n * 256 * 256
    assert g["conv3_1"]["fwd_bytes"] == 4 * (n * 256 + 256 * 256)
    assert g["conv3_1"]["bwd_bytes"] == 4 * (2 * n * 256 + 256 * 256)


def test_evaluation_counts_every_level_forward_and_back():
    e = counts.evaluation({"levels_num": 2, "base_diameter": 256})
    assert e["levels"] == [(512, 512), (256, 256)]
    convs = sum(o for o, _ in e["conv_calls"])
    assert convs == 2 * (hand_conv_forward(512, 512)
                         + hand_conv_forward(256, 256))
    assert len(e["conv_calls"]) == 2 * 2 * 13
    assert len(e["gram_calls"]) == 2 * 2 * 5
    e4 = counts.evaluation({"levels_num": 4, "base_diameter": 256})
    assert sum(o for o, _ in e4["conv_calls"]) == pytest.approx(8047.3e9,
                                                                rel=1e-3)


def test_least_seconds_takes_the_larger_bound():
    calls = [(495e12, 0.0), (0.0, 3.35e12), (495e12, 6.7e12)]
    assert counts.least_seconds(calls, 495e12, 3.35e12) == pytest.approx(4.0)


def test_peaks_by_precision():
    assert peaks.peak_ops({"compute_dtype": "float32"}) == 495e12
    assert peaks.peak_ops({"compute_dtype": "bfloat16"}) == 989e12


def test_idle_share_over_a_stall():
    """Kernels busy 0-40 and 50-60 of a 0-100 window, overlapping ones
    merged, one stall 60-100 under a host op: busy 0.5 of the window."""
    dev = [(0, 30, "k1"), (10, 40, "k2"), (50, 60, "k1")]
    host = [(0, 100, "outer"), (55, 95, "numpy work"), (41, 49, "launch")]
    t = TraceData(window_ns=(0, 100), device=dev, host=host,
                  host_launches=2, runtime_calls=3)
    assert t.busy_s == pytest.approx(50e-9)
    assert t.window_s == pytest.approx(100e-9)
    gaps = t.idle_gaps()
    assert gaps[0] == ["host: numpy work", pytest.approx(40e-9)]
    assert gaps[1] == ["host: launch", pytest.approx(10e-9)]
    assert t.top_device_ops()[0] == ["k1", pytest.approx(40e-9)]
    secs, n = t.device_seconds(lambda name: name == "k2")
    assert (secs, n) == (pytest.approx(30e-9), 1)
