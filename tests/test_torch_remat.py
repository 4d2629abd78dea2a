"""remat_levels (per-level activation checkpointing) and memory_stats in
the port, on the CPU.

With cfg.remat_levels each pyramid level's pass runs under non-reentrant
torch.utils.checkpoint: the backward recomputes the level's activations,
the same ops on the same values, so losses and gradients are the same
bits as without it (the JAX package's tests/test_misc.py:23-37 holds its
jax.checkpoint to rtol 1e-5 / 1e-4). Against the JAX package with remat
on, a 3-step Adam job keeps that test's tolerances: loss rtol 1e-5, image
rtol 1e-4 / atol 1e-5.

parallel/memory.py counts what autograd saves; the tests hold the counts
to the bytes of the VGG19 activations computed from the level shapes.
"""

import dataclasses

import numpy as np
import pytest
import torch

from artstyletransfer_tpu.config import Config as JConfig
from artstyletransfer_tpu.engine.transfer import TransferJob as JTransferJob
from artstyletransfer_tpu_torch.config import Config
from artstyletransfer_tpu_torch.engine.pyramid import level_shape
from artstyletransfer_tpu_torch.engine.transfer import TransferJob
from artstyletransfer_tpu_torch.parallel import memory as pmemory
from artstyletransfer_tpu_torch.parallel.batch import BatchedTransferJob
from artstyletransfer_tpu_torch.parallel.live import LiveBatchRunner
from artstyletransfer_tpu_torch.parallel.mesh import jobs_mesh


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


BASE = dict(levels_num=3, base_diameter=16, optimizer="adam")


def _remat(cfg: Config, on: bool) -> Config:
    return dataclasses.replace(cfg, remat_levels=on)


@pytest.mark.parametrize("graphs", [False, True])
@pytest.mark.parametrize("lanes", [1, 3])
def test_remat_evaluation_is_bit_equal(images, vgg_params, lanes, graphs):
    """One loss-and-gradient evaluation, eager and through the graphs'
    eager capture seam: remat on and off give the same bits."""
    content, style = images
    out = []
    for on in (False, True):
        cfg = _remat(Config(**BASE), on)
        job = BatchedTransferJob([content] * lanes, [style] * lanes, cfg,
                                 params=vgg_params, device="cpu",
                                 graphs=graphs)
        x = job._x0 + torch.linspace(-3.0, 3.0, job._x0.shape[1])
        out.append(job._loss_grad(x))
        if graphs:  # a replay of the captured evaluation
            out.append(job._loss_grad(x))
    (f0, g0), *rest = out
    for f, g in rest:
        assert torch.equal(f, f0) and torch.equal(g, g0)
    assert torch.isfinite(g0).all() and g0.abs().sum() > 0


def test_remat_jobs_are_bit_equal(images, vgg_params):
    """A job and a 3-lane batch (Adam and L-BFGS) yield the same images
    and losses with remat on and off."""
    content, style = images
    for opt in ("adam", "lbfgs"):
        cfg = Config(**dict(BASE, optimizer=opt, iters_num=4,
                            stream_every=2, lbfgs_history=3))
        runs = [list(TransferJob(content, style, _remat(cfg, on),
                                 params=vgg_params, device="cpu").run())
                for on in (False, True)]
        for (d0, i0, f0), (d1, i1, f1) in zip(*runs):
            assert d0 == d1 and f0 == f1
            np.testing.assert_array_equal(i0, i1)
        batches = [list(BatchedTransferJob(
            [content, content[::-1], content[:, ::-1]], [style] * 3,
            _remat(cfg, on), params=vgg_params, device="cpu").run())
            for on in (False, True)]
        for (d0, i0, f0), (d1, i1, f1) in zip(*batches):
            assert d0 == d1
            np.testing.assert_array_equal(f0, f1)
            np.testing.assert_array_equal(i0, i1)


def test_remat_matches_jax_remat(images, vgg_params):
    """A 3-step Adam job with remat against the JAX package's TransferJob
    with remat_levels=True, on the same seeded weights and images."""
    content, style = images
    kw = dict(levels_num=2, iters_num=3, base_diameter=16,
              optimizer="adam", stream_every=3, remat_levels=True)
    _, j_img, j_loss = list(JTransferJob(content, style, JConfig(**kw),
                                         params=vgg_params).run())[-1]
    _, t_img, t_loss = list(TransferJob(content, style, Config(**kw),
                                        params=vgg_params,
                                        device="cpu").run())[-1]
    np.testing.assert_allclose(t_loss, float(j_loss), rtol=1e-5)
    np.testing.assert_allclose(t_img, np.asarray(j_img), rtol=1e-4,
                               atol=1e-5)


def test_remat_live_runner(images, vgg_params):
    """The live runner steps a remat batch as it steps one without."""
    content, style = images
    finals = []
    for on in (False, True):
        cfg = _remat(Config(**dict(BASE, iters_num=4, stream_every=2)), on)
        runner = LiveBatchRunner(cfg, params=vgg_params, device="cpu")
        runner.submit("a", content, style)
        runner.step()
        runner.submit("b", content[::-1], style)  # joins at the boundary
        done = {}
        while runner.active:
            done.update(runner.step().finished)
        finals.append(done)
    assert finals[0].keys() == finals[1].keys() == {"a", "b"}
    for key in finals[0]:
        np.testing.assert_array_equal(finals[0][key][0], finals[1][key][0])
        assert finals[0][key][1] == finals[1][key][1]


# ---- memory_stats ----------------------------------------------------------

# channels and convs of the truncated VGG19's five blocks (a 2x2 pool
# after each of the first four)
_CHANNELS = (64, 128, 256, 512, 512)
_CONVS = (2, 2, 4, 4, 1)


def level_bytes(lanes: int, h: int, w: int, lower: bool) -> int:
    """The bytes autograd saves for one level pass of `lanes` h x w
    float32 images, the input image left out: each conv's ReLU output
    that the next conv reads (and conv5_1's, for its ReLU mask), each
    pool's output and its byte per pooled value (models/vgg19.py Vgg19Fn:
    the full-size map before a pool is not kept), conv4_2's content
    difference, each style layer's Gram and the TV means. A lower level's
    image is a strided downscale, of which the TV keeps a contiguous
    copy."""
    total = 0
    for k, (c, convs) in enumerate(zip(_CHANNELS, _CONVS)):
        full = convs if k == 4 else convs - 1
        total += full * lanes * (h >> k) * (w >> k) * c * 4
        if k < 4:
            total += lanes * (h >> (k + 1)) * (w >> (k + 1)) * c * (4 + 1)
        total += lanes * c * c * 4
    total += lanes * (h >> 3) * (w >> 3) * 512 * 4 + lanes * 2 * 4
    if lower:
        total += lanes * h * w * 3 * 4
    return total


@pytest.mark.parametrize("lanes", [1, 3])
def test_memory_stats_saved_bytes(lanes):
    """Remat saves the lower levels' activations at the peak: the saved
    bytes without it minus those with it and the top level's
    recomputation are the lower levels' share, exactly."""
    hw = (32, 40)
    stats = {on: pmemory.memory_stats(
        _remat(Config(**BASE), on), hw, lanes, device="cpu")
        for on in (False, True)}
    shapes = [level_shape(*hw, lvl, 16) for lvl in range(2, -1, -1)]
    per_level = [level_bytes(lanes, h, w, lvl > 0)
                 for lvl, (h, w) in enumerate(shapes)]
    off, on = stats[False], stats[True]
    assert off["recompute_peak_bytes"] == 0
    assert on["recompute_peak_bytes"] == per_level[0]
    assert (off["saved_activation_bytes"] - on["saved_activation_bytes"]
            - on["recompute_peak_bytes"]) == sum(per_level[1:])
    assert (on["saved_activation_bytes"] + on["recompute_peak_bytes"]
            < off["saved_activation_bytes"])
    assert off["argument_bytes"] == on["argument_bytes"]
    for s in (off, on):
        assert s["predicted_bytes"] == (s["argument_bytes"]
                                        + s["saved_activation_bytes"]
                                        + s["recompute_peak_bytes"])
        assert "peak_bytes" not in s  # measured on CUDA only


def test_memory_stats_extrapolation_is_exact():
    """The counts taken on one and two lanes extrapolate to what a
    3-lane evaluation saves, counted directly."""
    cfg = _remat(Config(**BASE), True)
    job = BatchedTransferJob([np.full((32, 40, 3), 0.5, np.float32)] * 3,
                             [np.full((24, 24, 3), 0.3, np.float32)] * 3,
                             cfg, device="cpu")
    one, two, three = (pmemory._count(job, b) for b in (1, 2, 3))
    assert three == tuple(a + 2 * (b - a) for a, b in zip(one, two))


@pytest.mark.parametrize("opt", ["adam", "lbfgs", "lbfgs_grams_bf16"])
def test_memory_stats_argument_bytes(opt):
    """argument_bytes is the sum of the job's tensors: weights, targets,
    images and the optimizer state of an initialised optimizer."""
    kw = {"adam": dict(optimizer="adam"),
          "lbfgs": dict(optimizer="lbfgs", lbfgs_history=5),
          "lbfgs_grams_bf16": dict(optimizer="lbfgs", lbfgs_history=5,
                                   lbfgs_grams="incremental",
                                   lbfgs_state_dtype="bfloat16")}[opt]
    cfg = Config(**dict(BASE, levels_num=2, **kw))
    stats = pmemory.memory_stats(cfg, (24, 32), 2, device="cpu")
    rng = np.random.default_rng(cfg.seed)
    contents = [rng.random((24, 32, 3), dtype=np.float32) for _ in range(2)]
    job = BatchedTransferJob(contents, contents, cfg, device="cpu")
    opt_state = job.init_opt(job._x0.clone())
    tensors = [t for layer in job.params.values() for t in layer.values()]
    tensors += [t for c, grams in job.targets for t in (c, *grams)]
    tensors += [job._x0, *opt_state.leaves().values()]
    assert stats["argument_bytes"] == sum(t.numel() * t.element_size()
                                          for t in tensors)


def test_memory_stats_mesh_and_space_raise():
    """A value that is not a mesh raises; shard_space without a mesh does
    nothing (the JAX package's rule; it raised before space sharding was
    ported); on a jobs mesh the counts are one card's, for its share of
    the padded batch."""
    cfg = Config(**BASE)
    with pytest.raises(TypeError, match="mesh"):
        pmemory.memory_stats(cfg, (32, 40), mesh=object(), device="cpu")
    no_mesh = pmemory.memory_stats(cfg, (32, 40), shard_space=True,
                                   device="cpu")
    assert no_mesh == pmemory.memory_stats(cfg, (32, 40), device="cpu")
    mesh = jobs_mesh(devices=["cpu", "cpu"])
    on_mesh = pmemory.memory_stats(cfg, (32, 40), 3, mesh=mesh)
    one_card = pmemory.memory_stats(cfg, (32, 40), 2, device="cpu")
    assert on_mesh == dict(one_card, jobs_axis=2, lanes_per_card=2)
