"""The port's batched job queue against the JAX package's, on the CPU.

Covers the batched plain Gram / Gram-backward / TV and the per-lane
level_loss (against the JAX functions under jax.vmap), the lane forms of
L-BFGS, BatchedTransferJob (against the JAX package's BatchedTransferJob
with mesh=None, and against single jobs), the queue helpers, run_job_queue
and queue_cli.

Tolerances: float32 sums in other orders give ~1e-6 relative noise; the
batch-level checks keep tests/test_parallel.py's rtol 1e-3 (losses) and
1e-3 (images). Multi-step L-BFGS branches on float32 comparisons of
1e8-sized losses, so its cross-framework check runs on inputs whose line
searches make the same decisions in both packages, and the lockstep
masking of the lane forms is checked exactly instead: on the CPU a lane's
values do not depend on its neighbours, so a lane must reproduce itself
bit for bit whatever runs beside it.
"""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from artstyletransfer_tpu.config import Config as JConfig
from artstyletransfer_tpu.models.vgg19 import extract_features as jax_feats
from artstyletransfer_tpu.ops.gram import gram_matrix as jax_gram
from artstyletransfer_tpu.ops.losses import level_loss as jax_level_loss
from artstyletransfer_tpu.ops.pallas_kernels import (
    _gram_bwd_impl,
    gram_pallas,
    tv_pallas,
)
from artstyletransfer_tpu.parallel import batch as jbatch
from artstyletransfer_tpu_torch.config import Config
from artstyletransfer_tpu_torch.engine import lbfgs as tl
from artstyletransfer_tpu_torch.engine.init_pipeline import build_init_image
from artstyletransfer_tpu_torch.engine.transfer import TransferJob
from artstyletransfer_tpu_torch.kernels import gram as kgram
from artstyletransfer_tpu_torch.kernels import tv as ktv
from artstyletransfer_tpu_torch.models.vgg19 import extract_features
from artstyletransfer_tpu_torch.models.weights import params_from_jax
from artstyletransfer_tpu_torch.ops.losses import level_loss
from artstyletransfer_tpu_torch.ops.tv import lane_total_variation
from artstyletransfer_tpu_torch.parallel import batch as pbatch
from artstyletransfer_tpu_torch.parallel.mesh import jobs_mesh

STYLE = (0, 1, 2, 3, 5)
WEIGHTS = (1e3, 4e5, 1e2)


@pytest.fixture(scope="module")
def jobs_data():
    """tests/test_parallel.py's jobs."""
    rng = np.random.default_rng(11)
    contents = [rng.random((32, 48, 3)).astype(np.float32) for _ in range(4)]
    styles = [rng.random((24, 24, 3)).astype(np.float32) for _ in range(4)]
    return contents, styles


@pytest.fixture
def same_native(monkeypatch):
    """Both packages on the same host resize path (see test_torch_ops)."""
    import artstyletransfer_tpu.native as jax_native
    import artstyletransfer_tpu_torch.native as port_native

    if jax_native.available() != port_native.available():
        monkeypatch.setattr(jax_native, "available", lambda: False)
        monkeypatch.setattr(port_native, "available", lambda: False)


@pytest.fixture
def jax_native_loaded():
    """The JAX package's native image library loaded in this process, if
    it failed to load while another worker was writing it (see
    tests/test_torch_graphs.py's load_jax_native): the stop_tol check
    below parts on the numpy path's last bits."""
    import os
    import time

    import artstyletransfer_tpu.native as jax_native

    for _ in range(20):
        if jax_native.available() or os.environ.get("ASTT_NO_NATIVE"):
            return
        time.sleep(0.5)
        jax_native._tried = False  # its file may be whole now


# ---- batched kernels' plain versions and per-lane losses ------------------


def test_batched_gram_plain_matches_vmapped_pallas(rng):
    """One (B, n, c) stack against _gram_kernel / _gram_bwd_kernel
    (interpret mode) under jax.vmap, rtol 1e-5 as in test_torch_kernels."""
    b, h, w, c = 3, 8, 12, 64
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    g = rng.standard_normal((b, c, c)).astype(np.float32)
    ref = np.asarray(jax.vmap(lambda xi: gram_pallas(xi[None], True, True)[0])(
        jnp.asarray(x)))
    f = torch.from_numpy(x).reshape(b, h * w, c)
    ours = kgram.gram(f, 1.0 / (c * h * w))
    assert ours.shape == (b, c, c)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-6)
    ref_bwd = np.asarray(jax.vmap(
        lambda fi, gi: _gram_bwd_impl(fi[None], gi[None], interpret=True)[0])(
            jnp.asarray(x), jnp.asarray(g)))
    ours_bwd = kgram.gram_bwd(f, torch.from_numpy(g))
    assert ours_bwd.shape == (b, h * w, c)
    np.testing.assert_allclose(ours_bwd.numpy(), ref_bwd.reshape(b, h * w, c),
                               rtol=1e-5, atol=1e-4)


def test_lane_tv_matches_vmapped_pallas(rng):
    """Per-lane sums and per-lane squared-mean TV (each image its own
    denominators) against tv_pallas (interpret) under jax.vmap; the
    gradient of the lanes' sum against jax.grad of the same. rtol 1e-5 on
    values, 1e-4 on the gradient, as in test_torch_kernels."""
    y = (rng.standard_normal((3, 9, 13, 3)) * 50).astype(np.float32)
    yt = torch.from_numpy(y)
    sums = ktv.tv_lane_sums(yt)
    assert sums.shape == (3, 2)
    np.testing.assert_allclose(
        sums.numpy(),
        np.stack([np.abs(np.diff(y, axis=2)).sum(axis=(1, 2, 3)),
                  np.abs(np.diff(y, axis=1)).sum(axis=(1, 2, 3))], axis=1),
        rtol=1e-5)

    def lanes(yy):
        return jax.vmap(lambda yi: tv_pallas(yi[None], interpret=True))(yy)

    ref = np.asarray(lanes(jnp.asarray(y)))
    g_ref = np.asarray(jax.grad(lambda yy: jnp.sum(lanes(yy)))(jnp.asarray(y)))
    yg = yt.clone().requires_grad_(True)
    ours = lane_total_variation(yg)
    np.testing.assert_allclose(ours.detach().numpy(), ref, rtol=1e-5)
    ours.sum().backward()
    np.testing.assert_allclose(yg.grad.numpy(), g_ref, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("fused", [True, False])
def test_lane_level_loss_matches_vmapped_jax(vgg_params, fused):
    """Two lanes of level_loss against the JAX level_loss under jax.vmap
    (each lane a batch of one): every (B,) component at rtol 1e-4 and the
    gradient of the lanes' total at 1e-3 of its largest entry, as
    test_torch_ops' single-lane check."""
    rng = np.random.default_rng(5)
    x, content, style = ((rng.random((2, 32, 32, 3)) * 255 - 120)
                         .astype(np.float32) for _ in range(3))

    def targets(c1, s1):
        cf, sf = jax_feats(vgg_params, c1), jax_feats(vgg_params, s1)
        return cf[4], tuple(jax_gram(sf[i]) for i in STYLE)

    t_content, t_grams = jax.vmap(lambda c, s: targets(c[None], s[None]))(
        jnp.asarray(content), jnp.asarray(style))

    def one(xi, tc, tg):
        xi = xi[None]
        ll = jax_level_loss(jax_feats(vgg_params, xi), tc, tg, xi, *WEIGHTS,
                            4, STYLE, fused_style_bwd=fused)
        return ll.total, ll

    def total(xx):
        tot, ll = jax.vmap(one)(xx, t_content, t_grams)
        return jnp.sum(tot), ll

    (_, ll_j), g_j = jax.value_and_grad(total, has_aux=True)(jnp.asarray(x))

    params = params_from_jax(vgg_params)
    xt = torch.from_numpy(x).requires_grad_(True)
    ll_t = level_loss(extract_features(params, xt),
                      torch.from_numpy(np.array(t_content)[:, 0]),
                      [torch.from_numpy(np.array(g)[:, 0]) for g in t_grams],
                      xt, *WEIGHTS, 4, STYLE, fused_style_bwd=fused)
    ll_t.total.sum().backward()
    for name in ("total", "content", "style", "tv"):
        ours = getattr(ll_t, name).detach().numpy()
        assert ours.shape == (2,), name
        np.testing.assert_allclose(ours, np.asarray(getattr(ll_j, name)),
                                   rtol=1e-4, err_msg=name)
    g_j = np.asarray(g_j)
    np.testing.assert_allclose(xt.grad.numpy(), g_j, rtol=1e-3,
                               atol=1e-3 * np.abs(g_j).max())


# ---- L-BFGS over lanes -------------------------------------------------------

_A = np.random.default_rng(0).standard_normal((3, 40)).astype(np.float32)


def _lanes_loss_grad(x):
    x = x.detach().requires_grad_(True)
    f = (torch.sum((x - torch.from_numpy(_A)) ** 4, dim=1)
         + torch.sum(torch.sin(3 * x), dim=1))
    (g,) = torch.autograd.grad(f.sum(), x)
    return f.detach(), g


@pytest.mark.parametrize("t_init", ["lr", "unit"])
def test_lane_lbfgs_step_matches_single_steps(t_init):
    """Three lanes on a smooth test function, each with its own minimum:
    lane_lbfgs_step makes each lane's lbfgs_step decisions (same
    evaluation counts and history) and lands on the same point within
    float32 rounding (dot products summed in another order)."""
    lane = []
    for b in range(3):
        def lg(x, b=b):
            f, g = _lanes_loss_grad(x.expand(3, -1))
            return f[b], g[b]
        x = torch.zeros(40)
        st = tl.init_state(lg, x, history=3)
        for _ in range(5):
            x, st = tl.lbfgs_step(lg, x, st, 0.5, t_init=t_init)
        lane.append((x, st))
    x = torch.zeros((3, 40))
    st = tl.lane_init_state(_lanes_loss_grad, x, history=3)
    for _ in range(5):
        x, st = tl.lane_lbfgs_step(_lanes_loss_grad, x, st,
                                   np.full(3, 0.5, np.float32), t_init=t_init)
    assert st.n_iter == 5
    for b, (xb, sb) in enumerate(lane):
        assert int(st.count[b]) == sb.count and int(st.n_evals[b]) == sb.n_evals
        np.testing.assert_allclose(float(st.f[b]), sb.f, rtol=1e-5)
        np.testing.assert_allclose(x[b].numpy(), xb.numpy(), rtol=1e-4,
                                   atol=1e-5)


def test_lane_direction_forms_agree(rng):
    s_hist = torch.from_numpy(rng.standard_normal((2, 4, 32)).astype(np.float32))
    y_hist = s_hist * 1.5 + 0.1
    rho = 1.0 / (s_hist * y_hist).sum(dim=2)
    g = torch.from_numpy(rng.standard_normal((2, 32)).astype(np.float32))
    st = tl.LaneLbfgsState(s_hist, y_hist, rho, np.array([6, 2]),
                           np.zeros(2, np.float32), g, np.ones(2, np.int64), 6)
    a = tl._lane_two_loop_direction(g, st, "matrix")
    b = tl._lane_two_loop_direction(g, st, "loop")
    torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError):
        tl._lane_two_loop_direction(g, st, "nope")


# ---- BatchedTransferJob --------------------------------------------------------


def _port_batch(contents, styles, cfg, params, **kw):
    job = pbatch.BatchedTransferJob(contents, styles, cfg, params=params,
                                    device="cpu", **kw)
    return list(job.run())[-1]


@pytest.mark.parametrize("kw,iters,data_seed", [
    (dict(optimizer="adam"), 6, 11),
    (dict(optimizer="lbfgs", lbfgs_t_init="unit", lbfgs_history=3), 3, 4),
    (dict(optimizer="lbfgs", lbfgs_max_ls_steps=0, lbfgs_history=3), 3, 11),
], ids=["adam", "lbfgs_unit", "lbfgs_maxls0"])
def test_batched_job_matches_jax_and_single_jobs(vgg_params, kw, iters,
                                                 data_seed):
    """The three forms run_job_queue batches: the port's BatchedTransferJob
    against the JAX package's (mesh=None), and each lane against the
    port's single TransferJob at cfg.seed + lane (test_parallel.py's
    convention): losses at rtol 1e-3, images at rtol/atol 1e-3 — 1e-2
    after unit-opening L-BFGS, whose t = 1 steps carry the 1e-6 noise of
    each evaluation into the image at full size."""
    rng = np.random.default_rng(data_seed)
    width = 48 if data_seed == 11 else 40
    contents = [rng.random((32, width, 3)).astype(np.float32) for _ in range(2)]
    styles = [rng.random((24, 24, 3)).astype(np.float32) for _ in range(2)]
    base = dict(levels_num=2, iters_num=iters, base_diameter=16,
                stream_every=iters, **kw)
    jb = jbatch.BatchedTransferJob(contents, styles, JConfig(**base),
                                   params=vgg_params)
    _, j_imgs, j_losses = list(jb.run())[-1]
    done, imgs, losses = _port_batch(contents, styles, Config(**base),
                                     vgg_params)
    assert done == iters and imgs.shape == (2, 32, width, 3)
    assert losses.shape == (2,) and losses.dtype == np.float32
    img_tol = 1e-2 if kw.get("lbfgs_t_init") == "unit" else 1e-3
    np.testing.assert_allclose(losses, j_losses, rtol=1e-3)
    np.testing.assert_allclose(imgs, j_imgs, rtol=1e-3, atol=img_tol)
    for i in range(2):
        single = TransferJob(contents[i], styles[i],
                             Config(**dict(base, seed=i)), params=vgg_params,
                             device="cpu")
        _, img_i, loss_i = list(single.run())[-1]
        np.testing.assert_allclose(losses[i], loss_i, rtol=1e-3)
        np.testing.assert_allclose(imgs[i], img_i, rtol=1e-3, atol=img_tol)


@pytest.mark.parametrize("kw", [dict(lbfgs_t_init="unit"), dict(),
                                dict(lbfgs_max_ls_steps=0)],
                         ids=["unit", "lr_full_wolfe", "maxls0"])
def test_lanes_are_independent_of_their_neighbours(vgg_params, kw):
    """Lockstep masking, exactly: three jobs in one order, the same jobs
    permuted, and job 1 twice beside itself give bit-identical results for
    every job (lr-opening full-Wolfe searches run different lengths in
    different lanes, so a lane that finished early is masked for several
    rounds)."""
    rng = np.random.default_rng(2)
    contents = [rng.random((32, 40, 3)).astype(np.float32) for _ in range(3)]
    styles = [rng.random((24, 24, 3)).astype(np.float32) for _ in range(3)]
    cfg = Config(levels_num=2, iters_num=3, base_diameter=16, stream_every=3,
                 optimizer="lbfgs", lbfgs_history=3, **kw)
    inits = [build_init_image(cfg.init_method, c, s, cfg,
                              rng=np.random.default_rng(10 + i))[0]
             for i, (c, s) in enumerate(zip(contents, styles))]
    _, imgs, losses = _port_batch(contents, styles, cfg, vgg_params,
                                  init_overrides=inits)
    order = [2, 0, 1]
    _, p_imgs, p_losses = _port_batch(
        [contents[i] for i in order], [styles[i] for i in order], cfg,
        vgg_params, init_overrides=[inits[i] for i in order])
    for lane, job in enumerate(order):
        np.testing.assert_array_equal(p_imgs[lane], imgs[job])
        assert p_losses[lane] == losses[job]
    _, d_imgs, d_losses = _port_batch(
        [contents[1]] * 2, [styles[1]] * 2, cfg, vgg_params,
        init_overrides=[inits[1]] * 2)
    for lane in range(2):
        np.testing.assert_array_equal(d_imgs[lane], imgs[1])
        assert d_losses[lane] == losses[1]


def test_pad_batch_to_drops_replicas(jobs_data, vgg_params):
    """Padding replicates the last job and its results are dropped; the
    real lanes are bit-identical to the unpadded batch's."""
    contents, styles = jobs_data
    cfg = Config(levels_num=1, iters_num=2, base_diameter=16,
                 stream_every=2, optimizer="adam")
    job = pbatch.BatchedTransferJob(contents[:3], styles[:3], cfg,
                                    params=vgg_params, pad_batch_to=4,
                                    device="cpu")
    assert (job.batch, job.real_batch) == (4, 3)
    _, imgs, losses = list(job.run())[-1]
    assert imgs.shape[0] == 3 and losses.shape == (3,)
    _, imgs3, losses3 = _port_batch(contents[:3], styles[:3], cfg, vgg_params)
    np.testing.assert_array_equal(imgs, imgs3)
    np.testing.assert_array_equal(losses, losses3)
    quiet = list(job.run(stream_every=1, yield_images=False))
    assert quiet[0][1] is None and quiet[-1][1] is not None
    assert torch.is_tensor(quiet[0][2]) and quiet[0][2].shape == (4,)


def test_stop_tol_shrinks_the_batch_like_jax(jobs_data, vgg_params, capsys,
                                            jax_native_loaded):
    """Job 2's loss settles (relative change 0.004 from step 12 to 14, the
    others' changes >= 0.14), so at stop_tol 0.01 it latches and leaves the
    batch:
    3 lanes re-form at 2 by index_select on every state tensor, job 2's
    result freezes, the others run to the budget. Same chunks, losses and
    images as the JAX package's run (rtol 1e-3)."""
    contents, styles = jobs_data
    base = dict(levels_num=1, iters_num=16, base_diameter=16, stream_every=2,
                optimizer="adam", stop_tol=0.01)
    job = pbatch.BatchedTransferJob(contents[:3], styles[:3], Config(**base),
                                    params=vgg_params, device="cpu")
    out = list(job.run())
    assert "batch 3 -> 2" in capsys.readouterr().err
    j_out = list(jbatch.BatchedTransferJob(
        contents[:3], styles[:3], JConfig(**base), params=vgg_params).run())
    assert [d for d, _i, _l in out] == [d for d, _i, _l in j_out]
    assert out[-1][0] == 16
    for (_d, imgs, losses), (_jd, j_imgs, j_losses) in zip(out, j_out):
        np.testing.assert_allclose(losses, j_losses, rtol=1e-3)
        np.testing.assert_allclose(imgs, j_imgs, rtol=1e-3, atol=1e-3)
    settled = [d for d, _i, l in out if l[2] == out[-1][2][2]]
    assert settled == [14, 16]  # frozen from its latch on
    np.testing.assert_array_equal(out[-1][1][2], out[6][1][2])


def test_batch_rejects_mixed_shapes_and_unported_options(jobs_data,
                                                         vgg_params, rng):
    contents, styles = jobs_data
    cfg = Config(levels_num=1, base_diameter=16, iters_num=1)
    bad = rng.random((10, 10, 3)).astype(np.float32)
    with pytest.raises(ValueError, match="bucket_jobs"):
        pbatch.BatchedTransferJob([contents[0], bad], styles[:2], cfg,
                                  params=vgg_params, device="cpu")
    with pytest.raises(TypeError, match="mesh"):  # not a mesh
        pbatch.BatchedTransferJob(contents[:1], styles[:1], cfg,
                                  params=vgg_params, device="cpu",
                                  mesh=object())
    # shard_space without a mesh does nothing, as in the JAX package
    alone = pbatch.BatchedTransferJob(contents[:1], styles[:1], cfg,
                                      params=vgg_params, device="cpu",
                                      shard_space=True)
    assert alone.space is None and alone.shards is None
    # a jobs mesh runs: one job padded to a lane per shard
    mesh = jobs_mesh(devices=["cpu", "cpu"])
    b = pbatch.BatchedTransferJob(contents[:1], styles[:1], cfg,
                                  params=vgg_params, mesh=mesh)
    assert (b.batch, b.real_batch, len(b.shards)) == (2, 1, 2)
    _d, imgs, losses = list(b.run())[-1]
    assert imgs.shape[0] == 1 and np.isfinite(losses).all()


def test_entry_points_raise_without_cuda(monkeypatch, jobs_data):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    contents, styles = jobs_data
    cfg = Config(levels_num=1, base_diameter=16, iters_num=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        pbatch.BatchedTransferJob(contents[:1], styles[:1], cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        pbatch.run_job_queue([("a", contents[0], styles[0])], cfg)
    from artstyletransfer_tpu_torch.frontends.queue_cli import main

    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--pair", "a.jpg", "b.jpg", "--output-dir", "out", "--quiet"])


# ---- queue helpers against the JAX package's ---------------------------------


def _grid():
    for opt, max_ls, t_init in [("adam", 25, "lr"), ("lbfgs", 25, "lr"),
                                ("lbfgs", 25, "unit"), ("lbfgs", 0, "lr")]:
        for history in (100, 10):
            for levels, base in [(1, 16), (2, 256), (3, 256)]:
                for stop_tol in (0.0, 0.05):
                    yield dict(optimizer=opt, lbfgs_max_ls_steps=max_ls,
                               lbfgs_t_init=t_init, lbfgs_history=history,
                               levels_num=levels, base_diameter=base,
                               stop_tol=stop_tol)


def test_queue_policy_helpers_match_jax():
    """resolve_batch_policy, max_jobs_per_batch, resolve_group_cap,
    planned_round_sizes and the shrink ladder equal the JAX package's over
    a grid of configs, content shapes, queue sizes and options."""
    n = 0
    for kw in _grid():
        ours, ref = Config(**kw), JConfig(**kw)
        for policy in ("auto", "batched", "sequential"):
            assert (pbatch.resolve_batch_policy(ours, policy)
                    == jbatch.resolve_batch_policy(ref, policy))
        for shape in [(512, 512, 3), (384, 512, 3), (1080, 1920, 3)]:
            assert (pbatch.max_jobs_per_batch(ours, shape)
                    == jbatch.max_jobs_per_batch(ref, shape))
            for max_batch in (None, 3):
                for policy in ("auto", "sequential"):
                    assert (pbatch.resolve_group_cap(ours, shape, 1, policy,
                                                     max_batch)
                            == jbatch.resolve_group_cap(ref, shape, 1, policy,
                                                        max_batch))
                    for n_jobs in (1, 3, 8, 40):
                        for pad in (True, False):
                            n += 1
                            assert (pbatch.planned_round_sizes(
                                ours, shape, n_jobs, policy=policy,
                                max_batch=max_batch, pad_batches=pad)
                                == jbatch.planned_round_sizes(
                                    ref, shape, n_jobs, policy=policy,
                                    max_batch=max_batch, pad_batches=pad))
    assert n > 1000
    for size in range(1, 40):
        assert pbatch.shrink_target(size) == jbatch.shrink_target(size)
        assert pbatch.shrink_ladder(size) == jbatch.shrink_ladder(size)
    with pytest.raises(ValueError):
        pbatch.resolve_batch_policy(Config(), "nope")


def test_bucketing_and_canonicalize_match_jax(rng, same_native):
    """bucket_jobs groups alike; the aspect buckets, crops and resized
    contents/styles are bit-identical to the JAX package's."""
    assert pbatch.DEFAULT_ASPECT_BUCKETS == jbatch.DEFAULT_ASPECT_BUCKETS
    a = rng.random((8, 8, 3)).astype(np.float32)
    b = rng.random((8, 12, 3)).astype(np.float32)
    s = rng.random((6, 6, 3)).astype(np.float32)
    jobs = [("t1", a, s), ("t2", a.copy(), s.copy()), ("t3", b, s)]
    ours = {k: [j[0] for j in v] for k, v in pbatch.bucket_jobs(jobs).items()}
    ref = {k: [j[0] for j in v] for k, v in jbatch.bucket_jobs(jobs).items()}
    assert ours == ref and len(ours) == 2
    for levels, base in [(1, 16), (2, 16), (2, 256)]:
        kw = dict(levels_num=levels, base_diameter=base)
        for aspect in pbatch.DEFAULT_ASPECT_BUCKETS:
            assert (pbatch.bucket_content_shape(aspect, Config(**kw))
                    == jbatch.bucket_content_shape(aspect, JConfig(**kw)))
    for hw in [(33, 32), (50, 48), (64, 66), (100, 160), (90, 40), (27, 61)]:
        img = rng.random(hw + (3,)).astype(np.float32)
        np.testing.assert_array_equal(pbatch.crop_to_aspect_bucket(img),
                                      jbatch.crop_to_aspect_bucket(img))
        kw = dict(levels_num=2, base_diameter=16)
        np.testing.assert_array_equal(
            pbatch.canonicalize_content(img, Config(**kw)),
            jbatch.canonicalize_content(img, JConfig(**kw)))
        np.testing.assert_array_equal(
            pbatch.canonicalize_style(img, Config(**kw)),
            jbatch.canonicalize_style(img, JConfig(**kw)))


# ---- run_job_queue and queue_cli ---------------------------------------------


def test_run_job_queue_buckets_and_isolates_failures(jobs_data, vgg_params,
                                                     rng):
    """Mixed shapes: two buckets run, a third (a NaN content, poisoned by
    the nan check) fails alone; pad_batches pads the 3-job bucket to 4.
    Progress reaches 100% for every good job."""
    contents, styles = jobs_data
    other = rng.random((40, 40, 3)).astype(np.float32)
    poison = np.full((36, 36, 3), np.nan, np.float32)
    cfg = Config(levels_num=1, iters_num=2, base_diameter=16,
                 optimizer="adam", stream_every=1)
    jobs = [("a", contents[0], styles[0]), ("b", contents[1], styles[1]),
            ("c", other, styles[2]), ("p", poison, styles[3]),
            ("d", contents[2], styles[2])]
    seen = []
    results, failures = pbatch.run_job_queue(
        jobs, cfg, params=vgg_params, pad_batches=True, device="cpu",
        progress=lambda tid, pct, img, loss: seen.append((tid, pct)))
    assert set(results) == {"a", "b", "c", "d"}
    assert set(failures) == {"p"}
    assert isinstance(failures["p"], FloatingPointError)
    assert results["a"].shape == (16, 24, 3)
    assert {t for t, p in seen if p == 100.0} == {"a", "b", "c", "d"}
    # a sequential queue runs groups of one; job a is lane 0 (noise seed
    # cfg.seed + 0) either way
    seq, _ = pbatch.run_job_queue(jobs[:2], cfg, params=vgg_params,
                                  batch_policy="sequential", device="cpu")
    assert set(seq) == {"a", "b"}
    np.testing.assert_allclose(seq["a"], results["a"], rtol=1e-3, atol=1e-3)


def test_canonicalized_queue_collapses_buckets(vgg_params, rng):
    contents = [rng.random(hw + (3,)).astype(np.float32)
                for hw in [(33, 32), (50, 48), (64, 66)]]
    styles = [rng.random(hw + (3,)).astype(np.float32)
              for hw in [(20, 30), (40, 24), (32, 32)]]
    cfg = Config(levels_num=2, iters_num=2, base_diameter=16,
                 optimizer="adam", stream_every=2)
    results, failures = pbatch.run_job_queue(
        [(f"t{i}", c, s) for i, (c, s) in enumerate(zip(contents, styles))],
        cfg, params=vgg_params, canonicalize_styles=True,
        canonicalize_contents=True, stream_images=False, device="cpu")
    assert not failures
    assert {r.shape for r in results.values()} == {(32, 32, 3)}


@pytest.mark.parametrize("kw", [dict(optimizer="adam"),
                                dict(optimizer="lbfgs", lbfgs_t_init="unit"),
                                dict(optimizer="lbfgs")],
                         ids=["adam", "lbfgs_unit", "lbfgs_lr"])
def test_single_job_is_one_lane(vgg_params, kw):
    """TransferJob runs the same lane code as BatchedTransferJob, so a
    single job equals a batch of one bit for bit."""
    rng = np.random.default_rng(5)
    content = rng.random((32, 40, 3)).astype(np.float32)
    style = rng.random((24, 24, 3)).astype(np.float32)
    cfg = Config(levels_num=2, iters_num=3, base_diameter=16, stream_every=3,
                 lbfgs_history=3, **kw)
    _, img, loss = list(TransferJob(content, style, cfg, params=vgg_params,
                                    device="cpu").run())[-1]
    _, imgs, losses = _port_batch([content], [style], cfg, vgg_params)
    np.testing.assert_array_equal(imgs[0], img)
    assert losses[0] == np.float32(loss)


def test_queue_cli_cpu_run(tmp_path):
    """Manifest + --pair jobs end to end on the CPU: results saved, a job
    with a missing file fails alone (exit 1); unported flags exit with a
    usage error."""
    cv2 = pytest.importorskip("cv2")
    from artstyletransfer_tpu_torch.frontends.queue_cli import main

    rng = np.random.default_rng(1)
    for name, hw in [("c1.png", (20, 24)), ("c2.png", (20, 24)),
                     ("s.png", (16, 16))]:
        cv2.imwrite(str(tmp_path / name),
                    (rng.random(hw + (3,)) * 255).astype(np.uint8))
    manifest = tmp_path / "jobs.jsonl"
    manifest.write_text("\n".join(json.dumps(r) for r in [
        {"id": "one", "content": str(tmp_path / "c1.png"),
         "style": str(tmp_path / "s.png")},
        {"content": str(tmp_path / "missing.png"),
         "style": str(tmp_path / "s.png")}]) + "\n")
    out = tmp_path / "out"
    flags = ["--output-dir", str(out), "--device", "cpu", "--levels", "1",
             "--iters", "2", "--base-diameter", "16", "--optimizer", "adam",
             "--quiet", "--metrics", str(tmp_path / "m.jsonl")]
    rc = main(["--manifest", str(manifest),
               "--pair", str(tmp_path / "c2.png"), str(tmp_path / "s.png"),
               *flags])
    assert rc == 1
    assert sorted(p.name for p in out.iterdir()) == ["c2__s.jpg", "one.jpg"]
    assert cv2.imread(str(out / "one.jpg")).shape == (16, 19, 3)
    assert main(["--pair", str(tmp_path / "c1.png"), str(tmp_path / "s.png"),
                 *flags]) == 0
    for bad in (["--space", "2"], ["--resume"]):
        with pytest.raises(SystemExit):
            main(["--pair", "a.png", "b.png", *flags, *bad])

