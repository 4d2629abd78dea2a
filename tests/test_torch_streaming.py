"""Lookahead streaming (cfg.pipeline_streaming) in the port, on the CPU.

The port of the JAX package's tests/test_engine.py:193-252: the lookahead
path yields the same (steps, image, loss) tuples in the same order as the
sequential path, for a job and a batch, and a checkpoint written under
lookahead (one chunk ahead of the yields) resumes bit for bit. Beyond the
JAX tests: the order of work, chunk k's host copy issued before chunk
k+1 is dispatched and chunk k yielded after it; and L-BFGS, whose steps
read the device, streams sequentially in the port.
"""

import dataclasses

import numpy as np
import pytest
import torch

from artstyletransfer_tpu_torch.config import Config
from artstyletransfer_tpu_torch.engine import transfer
from artstyletransfer_tpu_torch.engine.transfer import TransferJob
from artstyletransfer_tpu_torch.parallel.batch import BatchedTransferJob


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny shapes: one intra-op thread, so parallel test workers do not
    oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(21)
    return (rng.random((32, 48, 3)).astype(np.float32),
            rng.random((24, 24, 3)).astype(np.float32))


BASE = Config(levels_num=1, iters_num=6, base_diameter=16, optimizer="adam",
              stream_every=2)
SEQ = dataclasses.replace(BASE, pipeline_streaming=False)


@pytest.mark.parametrize("optimizer", ["adam", "lbfgs"])
def test_lookahead_yields_identical_sequence(images, vgg_params, optimizer):
    content, style = images
    pipe_cfg = dataclasses.replace(BASE, optimizer=optimizer,
                                   lbfgs_history=3)
    seq_cfg = dataclasses.replace(pipe_cfg, pipeline_streaming=False)
    out_pipe = list(TransferJob(content, style, pipe_cfg, params=vgg_params,
                                device="cpu").run())
    out_seq = list(TransferJob(content, style, seq_cfg, params=vgg_params,
                               device="cpu").run())
    assert [d for d, _, _ in out_pipe] == [d for d, _, _ in out_seq] \
        == [2, 4, 6]
    for (_, i1, f1), (_, i2, f2) in zip(out_pipe, out_seq):
        assert isinstance(f1, float) and f1 == f2
        np.testing.assert_array_equal(i1, i2)

    bp = list(BatchedTransferJob([content, content[::-1]], [style] * 2,
                                 pipe_cfg, params=vgg_params,
                                 device="cpu").run())
    bs = list(BatchedTransferJob([content, content[::-1]], [style] * 2,
                                 seq_cfg, params=vgg_params,
                                 device="cpu").run())
    assert [d for d, _, _ in bp] == [d for d, _, _ in bs] == [2, 4, 6]
    for (_, i1, f1), (_, i2, f2) in zip(bp, bs):
        np.testing.assert_array_equal(f1, f2)
        np.testing.assert_array_equal(i1, i2)


def test_lookahead_order_of_work(images, vgg_params, monkeypatch):
    """Chunk k's copy is issued after its last step and before chunk
    k+1's first; chunk k is yielded after chunk k+1 was dispatched (and
    its copy issued); the last chunk is not copied. Sequential: each
    chunk is yielded before the next one starts."""
    content, style = images
    log = []
    step, copy = transfer._Adam.step, transfer.HostCopies.copy

    def logged_step(self, x, s):
        log.append(("step", int(s)))
        return step(self, x, s)

    def logged_copy(self, *tensors):
        log.append(("copy",))
        return copy(self, *tensors)

    monkeypatch.setattr(transfer._Adam, "step", logged_step)
    monkeypatch.setattr(transfer.HostCopies, "copy", logged_copy)
    for cfg in (BASE, SEQ):
        for done, _img, _f in TransferJob(content, style, cfg,
                                          params=vgg_params,
                                          device="cpu").run():
            log.append(("yield", done))
    steps = [("step", s) for s in range(6)]
    assert log[:11] == [*steps[:2], ("copy",), *steps[2:4], ("copy",),
                        ("yield", 2), *steps[4:], ("yield", 4), ("yield", 6)]
    assert log[11:] == [*steps[:2], ("yield", 2), *steps[2:4], ("yield", 4),
                        *steps[4:], ("yield", 6)]


def test_lbfgs_streams_sequentially(images, vgg_params, monkeypatch):
    """An L-BFGS step reads the device in its line search, so lookahead
    would only delay each progress image by a chunk: a job and a batch
    copy nothing ahead, whatever pipeline_streaming says."""
    content, style = images
    copies = []
    copy = transfer.HostCopies.copy

    def logged_copy(self, *tensors):
        copies.append(tensors)
        return copy(self, *tensors)

    monkeypatch.setattr(transfer.HostCopies, "copy", logged_copy)
    cfg = dataclasses.replace(BASE, optimizer="lbfgs", lbfgs_history=3)
    assert not transfer.async_steps(cfg) and transfer.async_steps(BASE)
    list(TransferJob(content, style, cfg, params=vgg_params,
                     device="cpu").run())
    list(BatchedTransferJob([content] * 2, [style] * 2, cfg,
                            params=vgg_params, device="cpu").run())
    assert copies == []


def test_lookahead_off_under_level_losses_and_stop(images, vgg_params):
    """report_level_losses and stop_tol read each chunk before the next:
    the same yields as the sequential path, level losses stored."""
    content, style = images
    job = TransferJob(content, style, BASE, params=vgg_params, device="cpu")
    seq = TransferJob(content, style, SEQ, params=vgg_params, device="cpu")
    a = list(job.run(report_level_losses=True))
    b = list(seq.run(report_level_losses=True))
    assert [(d, f) for d, _, f in a] == [(d, f) for d, _, f in b]
    assert job.last_level_losses == seq.last_level_losses
    stop = dataclasses.replace(BASE, stop_tol=0.5, iters_num=20)
    a = list(TransferJob(content, style, stop, params=vgg_params,
                         device="cpu").run())
    b = list(TransferJob(content, style,
                         dataclasses.replace(stop, pipeline_streaming=False),
                         params=vgg_params, device="cpu").run())
    assert [(d, f) for d, _, f in a] == [(d, f) for d, _, f in b]
    assert a[-1][0] < 20


def test_lookahead_checkpoint_resume(tmp_path, images, vgg_params):
    """The checkpoint runs one chunk ahead of the yields (chunk k+1 is
    dispatched, and saved, before chunk k is yielded): a run stopped after
    its first yield resumes from the step-4 save and lands bit for bit on
    the uninterrupted run's final state."""
    content, style = images
    path = str(tmp_path / "job.ckpt")
    full = list(TransferJob(content, style, BASE, params=vgg_params,
                            device="cpu").run())
    it = TransferJob(content, style, BASE, params=vgg_params,
                     device="cpu").run(checkpoint_path=path,
                                       checkpoint_every=2)
    assert next(it)[0] == 2  # chunk 2 already saved
    it.close()
    resumed = list(TransferJob(content, style, BASE, params=vgg_params,
                               device="cpu").run(
        checkpoint_path=path, checkpoint_every=2, resume=True))
    assert [d for d, _, _ in resumed] == [6]
    np.testing.assert_array_equal(resumed[-1][1], full[-1][1])
    assert resumed[-1][2] == full[-1][2]


def test_lookahead_batch_checkpoint_resume(tmp_path, images, vgg_params):
    content, style = images
    path = str(tmp_path / "batch.ckpt")

    def make():
        return BatchedTransferJob([content, content[::-1]], [style] * 2,
                                  BASE, params=vgg_params, device="cpu")

    full = list(make().run())
    it = make().run(checkpoint_path=path, checkpoint_every=2)
    assert next(it)[0] == 2
    it.close()
    resumed = list(make().run(checkpoint_path=path, checkpoint_every=2,
                              resume=True))
    assert [d for d, _, _ in resumed] == [6]
    np.testing.assert_array_equal(resumed[-1][1], full[-1][1])
    np.testing.assert_array_equal(resumed[-1][2], full[-1][2])
