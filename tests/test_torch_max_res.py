"""The reference's max-resolution job (levels_num=4, a 100-pair L-BFGS
history) on the port, at a small size on the CPU: the 4-level L-BFGS
job with carried Grams on the card step's eager seam against the
benchmark's plain reference (portbench/reference), the history budget
on a card and on the CPU, and the ``lbfgs.history`` span's attributes."""

import json
import os
import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from artstyletransfer_tpu_torch.config import Config
from artstyletransfer_tpu_torch.engine import lbfgs_card, transfer
from artstyletransfer_tpu_torch.parallel import batch as pbatch
from artstyletransfer_tpu_torch.parallel.batch import BatchedTransferJob
from artstyletransfer_tpu_torch.utils.metrics import recorded_spans
from portbench.reference import images, model, optim

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOP = 128  # base_diameter 16 at 4 levels


@pytest.fixture
def cpu_as_card(monkeypatch):
    """engages as on a card for plain CPU tensors: the production form
    then steps through CardSteps on its eager seam."""
    monkeypatch.setattr(lbfgs_card, "_card_device",
                        lambda x: isinstance(x, torch.Tensor))


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _weights():
    """Seeded He-normal VGG19 weights (HWIO), zero biases."""
    rng = np.random.default_rng(7)
    hwio, cin = {}, 3
    for name, cout in [l for l in model.LAYERS if l[0] != "pool"]:
        hwio[name] = {"w": (rng.standard_normal((3, 3, cin, cout))
                            * np.sqrt(2 / (9 * cin))).astype(np.float32),
                      "b": np.zeros(cout, np.float32)}
        cin = cout
    return hwio


def _images():
    yy, xx = np.mgrid[0:TOP, 0:TOP].astype(np.float32) / TOP
    content = np.stack([0.5 + 0.4 * np.sin(6 * xx + k) * np.cos(5 * yy)
                        for k in range(3)], -1).astype(np.float32)
    style = np.stack([0.5 + 0.5 * np.sin(20 * (xx[:16, :16]
                                               + yy[:16, :16]))] * 3,
                     -1).astype(np.float32)
    return content, style


def _fields():
    """The cell's configuration as run (portbench/configs), at base 16:
    4 levels, history 100, carried Grams, 12 steps, an image a step."""
    with open(os.path.join(ROOT, "portbench", "configs",
                           "vgg19-4l2k-lbfgs.json")) as fh:
        fields = json.load(fh)["fields"]
    assert fields["levels_num"] == 4 and fields["lbfgs_history"] == 100
    fields.update(base_diameter=16, iters_num=12, stream_every=1)
    return fields


def _config(fields):
    return Config(**{k: tuple(v) if isinstance(v, list) else v
                     for k, v in fields.items()})


@pytest.fixture(scope="module")
def max_res_run():
    """The port's 4-level job from the reference's initial image, as the
    served path runs it (one lane of BatchedTransferJob, graphed, the
    card step on its eager seam), under a profiler session, on one
    thread: (fields, inputs, the chunks, the spans)."""
    fields = _fields()
    hwio = _weights()
    content, style = _images()
    init = images.init_image(content, style, fields, 0)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(lbfgs_card, "_card_device",
                       lambda x: isinstance(x, torch.Tensor))
            job = BatchedTransferJob([content], [style], _config(fields),
                                     params=hwio, device="cpu", graphs=True,
                                     init_overrides=[init])
            t0 = time.time_ns()
            with profile(activities=[ProfilerActivity.CPU]):
                chunks = list(job.run())
    finally:
        torch.set_num_threads(threads)
    return fields, (hwio, content, style, init), chunks, recorded_spans(t0)


def test_four_level_lbfgs_meets_the_reference(max_res_run, one_thread):
    """Every step's delivered image and reported loss against the plain
    reference's objective, and the image after the first steps against
    torch's own L-BFGS from the same start.

    - The loss the port reports with each image is the reference's loss
      at that image within rtol 1e-5: both are float32 evaluations of
      one objective that sum in other orders (read: <= 1.6e-7; a
      bfloat16 evaluation parts by ~1e-3).
    - After one and two steps the image is torch.optim.LBFGS's within
      1e-2 of the distance it moved (read: 1.4e-3 and 3.6e-3): the
      port's strong-Wolfe interpolations run in float32, torch's in
      Python floats, so the step lengths part in their fourth digit;
      later steps part further, as any two roundings of L-BFGS do.
    """
    fields, (hwio, content, style, init), chunks, spans = max_res_run
    assert [c[0] for c in chunks] == list(range(1, 13))
    assert {s.attrs["path"] for s in spans if s.name == "lbfgs.step"} == {
        "card"}
    weights = model.weights_from_hwio(hwio, "cpu")
    obj = model.Objective(content, style, fields, weights, "cpu")
    x0 = torch.from_numpy(images.prepare(init).reshape(1, -1))

    def flat(img):
        return torch.from_numpy(images.prepare(img).reshape(1, -1))

    with model.full_float32(), torch.no_grad():
        for done, imgs, losses in chunks:
            assert imgs.shape == (1, TOP, TOP, 3)
            ref = float(obj.loss(flat(imgs[0]))[0])
            assert float(losses[0]) == pytest.approx(ref, rel=1e-5), done
    assert float(chunks[-1][2][0]) < 0.5 * float(obj.loss(x0)[0])
    with model.full_float32():
        for steps in (1, 2):
            ref = optim.retrace(obj, x0, fields, steps)
            xp = flat(chunks[steps - 1][1][0])
            gap = float((xp - ref["x"]).norm() / (ref["x"] - x0).norm())
            assert gap < 1e-2, (steps, gap)


def test_the_history_fills_past_its_first_pairs(max_res_run):
    """The accept graph's spans on the eager seam: one lane of the 128 px
    top level's 49,152 values, the pairs held after each accept ramping
    from 0 by one a step (12 steps, history 100); the speculative accept
    after the last step is never read and carries no pairs."""
    _f, _inputs, _chunks, spans = max_res_run
    history = [s for s in spans if s.name == "lbfgs.history"]
    assert len(history) == 13
    assert all(s.attrs["lanes"] == 1 and s.attrs["n"] == TOP * TOP * 3
               for s in history)
    assert [s.attrs.get("pairs") for s in history] == list(range(12)) + [
        None]


def _spans_of(job):
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        list(job.run())
    return recorded_spans(t0)


def _small_job(history=3, iters=6, lanes=1):
    rng = np.random.default_rng(1)
    contents = [rng.random((16, 16, 3), dtype=np.float32)
                for _ in range(lanes)]
    styles = [rng.random((16, 16, 3), dtype=np.float32)
              for _ in range(lanes)]
    cfg = Config(levels_num=1, base_diameter=16, iters_num=iters,
                 stream_every=2, optimizer="lbfgs", lbfgs_history=history,
                 lbfgs_grams="incremental")
    return BatchedTransferJob(contents, styles, cfg, params=_weights(),
                              device="cpu", graphs=True)


def test_history_span_attributes_on_the_eager_seam(cpu_as_card, one_thread):
    """lbfgs.history on the card step: lanes and n at the launch, pairs
    (summed over the lanes) at the next read, held at the history's
    length once the ring is full; one span a step, inside its
    lbfgs.step."""
    spans = _spans_of(_small_job(history=3, iters=6, lanes=2))
    history = [s for s in spans if s.name == "lbfgs.history"]
    steps = {s.id: s for s in spans if s.name == "lbfgs.step"}
    assert all(s.parent in steps for s in history)
    assert all(s.attrs["lanes"] == 2 and s.attrs["n"] == 16 * 16 * 3
               for s in history)
    assert [s.attrs.get("pairs") for s in history] == [
        0, 2, 4, 6, 6, 6, None]


def test_host_direction_span_attributes(one_thread):
    """On the host path (the CPU) lbfgs.direction carries the same
    attributes: the pairs its direction reads, before the step stores."""
    spans = _spans_of(_small_job(history=3, iters=6))
    direction = [s for s in spans if s.name == "lbfgs.direction"]
    assert [s.attrs["pairs"] for s in direction] == [0, 1, 2, 3, 3, 3]
    assert all(s.attrs["lanes"] == 1 and s.attrs["n"] == 16 * 16 * 3
               for s in direction)
    assert not [s for s in spans if s.name == "lbfgs.history"]


# torch's total_memory of an NVIDIA H100 80GB HBM3 (the budget read 68.66 GB
# there beside one 2048 px lane)
H100_TOTAL = 85_017_493_504


@pytest.fixture
def h100(monkeypatch):
    """get_device_properties as an H100 80GB reports it."""
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(
                            total_memory=H100_TOTAL))


def test_history_budget_on_a_card_and_on_the_cpu(h100):
    """The card's total memory less the batch's evaluation
    (EVAL_BYTES_PER_TOP_VALUE a lane per top-level value, a card's share
    over a space row); the JAX package's 8 GB on the CPU."""
    shapes = [(1, 2048, 2048, 3)]
    n = 2048 * 2048 * 3
    per = transfer.EVAL_BYTES_PER_TOP_VALUE
    assert transfer.lbfgs_history_budget_gb(shapes, device="cpu") == 8.0
    for batch, space in ((1, 1), (3, 1), (2, 4)):
        assert transfer.lbfgs_history_budget_gb(
            shapes, batch, space, "cuda:0") == pytest.approx(
                (H100_TOTAL - per * n * batch / space) / 1e9)


def test_the_max_resolution_job_fits_a_card_without_a_warning(h100, capsys):
    """4 levels, 2048 px, 100 float32 pairs (10.07 GB): no warning on an
    H100, where the 8 GB budget of the JAX package warned; the CPU keeps
    that budget and warns."""
    cfg = Config(levels_num=4, optimizer="lbfgs")
    shapes = [(1, 2048, 2048, 3)]
    assert transfer.lbfgs_history_gb(cfg, shapes) == pytest.approx(
        2 * 100 * 2048 * 2048 * 3 * 4 / 1e9)
    assert not transfer.warn_lbfgs_hbm(cfg, shapes, device="cuda:0")
    assert capsys.readouterr().err == ""
    assert transfer.warn_lbfgs_hbm(cfg, shapes, device="cpu")
    assert "10.1 GB" in capsys.readouterr().err


def test_the_warning_fires_where_the_history_stops_fitting(h100, capsys):
    """The threshold: the longest history whose rows fit beside one
    lane's evaluation passes, one pair more warns; the queue's cap is the
    most jobs that pass the same test."""
    shapes = [(1, 2048, 2048, 3)]
    n = 2048 * 2048 * 3
    room = H100_TOTAL - transfer.EVAL_BYTES_PER_TOP_VALUE * n
    longest = int(room // (2 * n * 4))
    for history, warns in ((longest, False), (longest + 1, True)):
        cfg = Config(levels_num=4, optimizer="lbfgs", lbfgs_history=history)
        assert transfer.warn_lbfgs_hbm(cfg, shapes,
                                       device="cuda:0") is warns
    capsys.readouterr()
    cfg = Config(levels_num=4, base_diameter=256, optimizer="lbfgs")
    cap = pbatch.max_jobs_per_batch(cfg, (2048, 2048), device="cuda:0")
    per_job = 2 * 100 * n * 4 + transfer.EVAL_BYTES_PER_TOP_VALUE * n
    assert cap == max(1, min(32, int(H100_TOTAL // per_job)))
    assert pbatch.max_jobs_per_batch(cfg, (2048, 2048), device="cpu") == 1
