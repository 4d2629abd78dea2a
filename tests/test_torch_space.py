"""Space sharding of the port (parallel/space.py) on the CPU: one job's
rows over the devices of a space row.

The CPU is one torch device, so a mesh that names it S times stands in
for S cards: every halo copy, partial sum and per-block kernel call of
the space path runs, on one device. Held here:
- each block op (the halo conv, the block downscale, the partial Grams
  and their sum, the content sums, the TV seam) against its whole
  counterpart, forward and backward, at S = 2 and 4, rtol 1e-5;
- the TV plain versions with h_total and a halo, summed over the blocks,
  against the JAX package's `_tv_impl` and its VJP (`tv_pallas`,
  interpret mode);
- the gate against the JAX package's `constrained_space_ok`, and the
  pool alignment it adds;
- a space Adam batch against the JAX package's constrained space batch
  on jobs_space_mesh(4, 2) (tests/test_round4_fixes.py's shape: rtol
  1e-4) and against the port's unsharded batch (rtol 1e-5);
- the L-BFGS lane forms over SpaceLanes against plain tensors on a
  quadratic, and a space L-BFGS batch against the unsharded one;
  convergence shrinking, checkpoints both ways, the memory report, the
  queue CLI, and that the one-card path keeps its bits.

The first L-BFGS step here opens at t = lr / |g|_1 (lr_start 1e4, about
1e-3): from the default lr of 10 the search extrapolates from t ~ 1e-6
over a loss that is nearly linear there, and its cubic steps turn the
1-ulp loss differences of a sharded sum (5.7e7 against 5.7e7 + 4) into
other trial points (PERF.md's space findings show such a trace).
"""

import shutil

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from artstyletransfer_tpu.config import Config as JConfig
from artstyletransfer_tpu.engine.transfer import (
    lbfgs_history_gb as jax_history_gb)
from artstyletransfer_tpu.ops.pallas_kernels import tv_pallas
from artstyletransfer_tpu.parallel import batch as jbatch
from artstyletransfer_tpu.parallel.mesh import (
    jobs_space_mesh as jjobs_space_mesh)
from artstyletransfer_tpu_torch.config import Config
from artstyletransfer_tpu_torch.engine import checkpoint as ckpt
from artstyletransfer_tpu_torch.engine import lbfgs
from artstyletransfer_tpu_torch.engine.transfer import (lbfgs_history_gb,
                                                        warn_lbfgs_hbm)
from artstyletransfer_tpu_torch.kernels import tv as ktv
from artstyletransfer_tpu_torch.models.vgg19 import (extract_features,
                                                     extract_features_blocks,
                                                     halo_conv)
from artstyletransfer_tpu_torch.models.weights import shared_params
from artstyletransfer_tpu_torch.ops.blocks import shard_sum
from artstyletransfer_tpu_torch.ops.gram import gram_matrix, space_gram_matrix
from artstyletransfer_tpu_torch.ops.losses import (StyleLayerMSE,
                                                   SpaceStyleLayerMSE,
                                                   content_loss,
                                                   space_content_loss)
from artstyletransfer_tpu_torch.ops.resize import (downscale2x,
                                                   downscale2x_blocks)
from artstyletransfer_tpu_torch.ops.tv import (lane_total_variation,
                                               space_total_variation)
from artstyletransfer_tpu_torch.parallel import batch as pbatch
from artstyletransfer_tpu_torch.parallel import memory as pmemory
from artstyletransfer_tpu_torch.parallel import space
from artstyletransfer_tpu_torch.parallel.mesh import jobs_space_mesh
from artstyletransfer_tpu_torch.parallel.space import SpaceLanes

SPACE_LBFGS = dict(optimizer="lbfgs", lbfgs_grams="incremental",
                   lbfgs_history=2, lbfgs_t_init="unit", lr_start=1e4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small shapes: one intra-op thread runs them as fast as many, and
    parallel test workers do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jobs64():
    """tests/test_round4_fixes.py's gate-passing jobs: 64 px contents,
    32 px styles."""
    rng = np.random.default_rng(7)
    contents = [rng.random((64, 64, 3)).astype(np.float32)
                for _ in range(4)]
    styles = [rng.random((32, 32, 3)).astype(np.float32) for _ in range(4)]
    return contents, styles


def cpu_mesh(jobs: int, n_space: int):
    return jobs_space_mesh(jobs, n_space, devices=["cpu"] * (jobs * n_space))


def row_blocks(x: torch.Tensor, n: int) -> list:
    """An NHWC tensor's rows cut into n equal blocks (views)."""
    return list(torch.split(x, x.shape[1] // n, dim=1))


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max())


# ---- each block op against the whole op ---------------------------------


def _grads(loss, inputs):
    return torch.autograd.grad(loss, inputs)


def _halo_conv_case(rng, n):
    x = torch.from_numpy(rng.standard_normal((2, 5, 4 * n, 7))
                         .astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((6, 5, 3, 3))
                         .astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(6).astype(np.float32))
    cot = torch.from_numpy(rng.standard_normal((2, 6, 4 * n, 7))
                           .astype(np.float32))
    xw = x.clone().requires_grad_(True)
    whole = F.conv2d(xw, w, b, padding=1)
    xb = [t.clone().requires_grad_(True)
          for t in torch.split(x, [4] * n, dim=2)]
    blocks = halo_conv(xb, [w] * n, [b] * n)
    (g_whole,) = _grads((whole * cot).sum(), [xw])
    g_blocks = _grads((torch.cat(blocks, 2) * cot).sum(), xb)
    return [(torch.cat(blocks, 2), whole),
            (torch.cat(g_blocks, 2), g_whole)]


def _image(rng, n, h=8, w=10):
    return torch.from_numpy((rng.standard_normal((2, h * n, w, 3)) * 50)
                            .astype(np.float32))


def _downscale_case(rng, n):
    x = _image(rng, n)
    xw = x.clone().requires_grad_(True)
    xb = [t.clone().requires_grad_(True) for t in row_blocks(x, n)]
    whole, blocks = downscale2x(xw), downscale2x_blocks(xb)
    cot = torch.from_numpy(rng.standard_normal(whole.shape)
                           .astype(np.float32))
    (gw,) = _grads((whole * cot).sum(), [xw])
    gb = _grads((torch.cat(blocks, 1) * cot).sum(), xb)
    return [(torch.cat(blocks, 1), whole), (torch.cat(gb, 1), gw)]


def _gram_case(rng, n):
    f = torch.from_numpy(np.abs(rng.standard_normal((2, 4 * n, 6, 16)))
                         .astype(np.float32))
    gt = torch.from_numpy(np.abs(rng.standard_normal((2, 16, 16)))
                          .astype(np.float32))
    fw = f.clone().requires_grad_(True)
    fb = [t.clone().requires_grad_(True) for t in row_blocks(f, n)]
    out = []
    for whole, blocks in (
            (StyleLayerMSE.apply(fw, gt), SpaceStyleLayerMSE.apply(gt, *fb)),
            ((gram_matrix(fw) * gt).sum(dim=(1, 2)),
             (space_gram_matrix(fb) * gt).sum(dim=(1, 2)))):
        (gw,) = _grads(whole.sum(), [fw])
        gb = _grads(blocks.sum(), fb)
        out += [(blocks, whole), (torch.cat(gb, 1), gw)]
    return out


def _content_case(rng, n):
    f = torch.from_numpy(rng.standard_normal((2, 4 * n, 6, 16))
                         .astype(np.float32))
    t = torch.from_numpy(rng.standard_normal((2, 4 * n, 6, 16))
                         .astype(np.float32))
    fw = f.clone().requires_grad_(True)
    fb = [b.clone().requires_grad_(True) for b in row_blocks(f, n)]
    whole = content_loss(t, fw)
    blocks = space_content_loss(row_blocks(t, n), fb)
    (gw,) = _grads(whole.sum(), [fw])
    gb = _grads(blocks.sum(), fb)
    return [(blocks, whole), (torch.cat(gb, 1), gw)]


def _seam_tv(y: torch.Tensor, n: int, g: torch.Tensor, means=None):
    """The plain seam versions over n row blocks of y (each with h_total
    and the next block's first row): (the blocks' means summed, the
    blocks' gradients joined, each halo row's gradient added to the row
    it came from) at the image's means (the summed ones by default)."""
    blocks = row_blocks(y, n)
    b, h = y.shape[:2]
    halos = [blocks[k + 1][:, 0].reshape(b, -1) if k + 1 < n else None
             for k in range(n)]
    summed = shard_sum([ktv.tv_plain(blk, h, hl)[1]
                        for blk, hl in zip(blocks, halos)])
    means = summed if means is None else means
    grads, seams = [], []
    for blk, hl in zip(blocks, halos):
        out = ktv.tv_bwd_plain(blk, g, means, h, hl)
        grads.append(out if hl is None else out[0])
        seams.append(None if hl is None else out[1])
    for k, seam in enumerate(seams[:-1]):
        grads[k + 1] = grads[k + 1].clone()
        grads[k + 1][:, 0] += seam.reshape(b, -1, y.shape[3])
    return summed, torch.cat(grads, 1)


def _tv_case(rng, n):
    """The plain seam versions per block, summed, and SpaceTvFn, against
    the whole image's plain TV and LaneTvFn."""
    y = _image(rng, n)
    g = torch.tensor([0.7, 1.3])
    blocks = row_blocks(y, n)
    _tv, means = ktv.tv_plain(y)
    parts, grads = _seam_tv(y, n, g, means)
    yw = y.clone().requires_grad_(True)
    yb = [b.clone().requires_grad_(True) for b in blocks]
    whole_fn, blocks_fn = lane_total_variation(yw), space_total_variation(yb)
    (gw,) = _grads((whole_fn * g).sum(), [yw])
    gb = _grads((blocks_fn * g).sum(), yb)
    return [(parts, means), (grads, ktv.tv_bwd_plain(y, g, means)),
            (blocks_fn, whole_fn), (torch.cat(gb, 1), gw)]


def _vgg_case(rng, n):
    """The six taps of extract_features over row blocks (a halo at every
    conv, the pools inside each block) at 32 rows a block."""
    params = shared_params(None, 0, torch.device("cpu"))
    x = torch.from_numpy((rng.random((1, 32 * n, 24, 3)) * 255 - 120)
                         .astype(np.float32))
    xw = x.clone().requires_grad_(True)
    xb = [t.clone().requires_grad_(True) for t in row_blocks(x, n)]
    whole = extract_features(params, xw)
    blocks = extract_features_blocks([params] * n, xb)
    out = [(torch.cat([b[i] for b in blocks], 1), whole[i])
           for i in range(6)]
    (gw,) = _grads(whole[4].sum() + whole[5].sum(), [xw])
    gb = _grads(sum(b[4].sum() + b[5].sum() for b in blocks), xb)
    return out + [(torch.cat(gb, 1), gw)]


CASES = {"halo_conv": _halo_conv_case, "downscale": _downscale_case,
         "gram": _gram_case, "content": _content_case, "tv": _tv_case,
         "vgg": _vgg_case}


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("op", list(CASES))
def test_block_op_matches_whole(rng, op, n):
    """Forward and backward of each block op, its blocks joined, against
    the whole op: rtol 1e-5 of the largest entry (sums in another order;
    the conv, the downscale and VGG are exact row by row on the CPU)."""
    for blocks, whole in CASES[op](rng, n):
        assert blocks.shape == whole.shape
        np.testing.assert_allclose(blocks.detach().numpy(),
                                   whole.detach().numpy(), rtol=0,
                                   atol=1e-5 * float(whole.detach().abs()
                                                     .max()))


@pytest.mark.parametrize("n", [2, 4])
def test_tv_seam_sums_match_jax(rng, n):
    """The plain seam versions (h_total and the next block's first row)
    summed over the blocks: the means squared against tv_pallas
    (interpret) and the blocks' gradients against its VJP
    (`_tv_vjp_bwd`), on the whole image: rtol 1e-5, atol 2e-7 (a seam
    row's gradient adds the halo's part to its own in another order: two
    ulps of the unit-sized sign terms, test_torch_tv.py's atol 1e-7 for
    one)."""
    y = (rng.standard_normal((1, 6 * n, 11, 3)) * 50).astype(np.float32)
    means, grads = _seam_tv(torch.from_numpy(y), n, torch.ones(1))
    tv = means[:, 0] ** 2 + means[:, 1] ** 2
    ref, vjp = jax.vjp(lambda t: tv_pallas(t, interpret=True),
                       jnp.asarray(y))
    np.testing.assert_allclose(tv.numpy(), [float(ref)], rtol=1e-5)
    np.testing.assert_allclose(grads.numpy(),
                               np.asarray(vjp(jnp.float32(1.0))[0]),
                               rtol=1e-5, atol=2e-7)


# ---- the gate -------------------------------------------------------------

JAX_TABLE = [  # tests/test_round4_fixes.py's table
    ([(1, 64, 64, 3), (1, 32, 32, 3)], 2),
    ([(1, 128, 128, 3), (1, 64, 64, 3)], 2),
    ([(1, 2048, 3072, 3), (1, 1024, 1536, 3), (1, 512, 768, 3),
      (1, 256, 384, 3)], 8),
    ([(1, 256, 384, 3)], 16),
]
ALIGNMENT = [  # pass the JAX gate, not the pool alignment
    ([(1, 80, 80, 3)], 2),
    ([(1, 160, 240, 3), (1, 80, 120, 3)], 2),
    ([(1, 1088, 1088, 3), (1, 544, 544, 3), (1, 272, 272, 3)], 8),
    ([(1, 200, 200, 3)], 4),
]


@pytest.mark.parametrize("shapes,n", JAX_TABLE + ALIGNMENT)
def test_gate_matches_jax_and_aligns_the_pools(shapes, n):
    """constrained_space_ok is the JAX package's; space_gate adds every
    level's height a multiple of 16 n (four whole pools a block)."""
    ours = space.constrained_space_ok(shapes, n)
    assert ours == jbatch.constrained_space_ok(shapes, n)
    aligned = all(s[1] % (16 * n) == 0 for s in shapes)
    assert space.space_gate(shapes, n)[0] == (ours and aligned)
    if (shapes, n) in ALIGNMENT:
        assert ours and not space.space_gate(shapes, n)[0]


def test_the_2k_job_passes_the_gate_at_2_4_and_8():
    """The 4-level 2048 px job (the large phase's, the JAX package's
    production target) shards at S = 2, 4 and 8, and the 16 px test
    shapes do not."""
    shapes = [(1, 2048 >> k, 2048 >> k, 3) for k in range(4)]
    for n in (2, 4, 8):
        assert space.space_gate(shapes, n) == (True, "")
    assert not space.space_gate([(1, 16, 20, 3)], 2)[0]


def test_history_budget_divides_by_space():
    """lbfgs_history_gb and the warning take the space axis, as the JAX
    package's do; the queue's group cap follows each card's share."""
    cfg = Config(optimizer="lbfgs")
    shapes = [(1, 2048, 2048, 3)]
    for n in (1, 2, 4):
        assert lbfgs_history_gb(cfg, shapes, 1, n) == pytest.approx(
            jax_history_gb(JConfig(optimizer="lbfgs"), shapes, 1, n))
    assert warn_lbfgs_hbm(cfg, shapes, 1)
    assert not warn_lbfgs_hbm(cfg, shapes, 1, space=2)
    big = Config(optimizer="lbfgs", levels_num=4, base_diameter=256)
    one = pbatch.max_jobs_per_batch(big, (2048, 2048))
    assert pbatch.max_jobs_per_batch(big, (2048, 2048), space=4) > one
    assert pbatch.bucket_space(big, (2048, 2048), 4) == 4
    assert pbatch.bucket_space(Config(levels_num=1, base_diameter=16),
                               (16, 16), 2) == 1


# ---- batches --------------------------------------------------------------


def test_space_adam_batch_matches_jax_and_unsharded(jobs64, vgg_params):
    """tests/test_round4_fixes.py's constrained batch (1 level, 64 px,
    jobs_space_mesh(4, 2)): the port on a CPU mesh of 8 entries, each
    jobs row a space row of 2 blocks; its first chunk's losses within
    rtol 1e-4 of the JAX package's constrained batch and 1e-5 of the
    port's unsharded batch."""
    contents, styles = jobs64
    base = dict(levels_num=1, iters_num=1, base_diameter=64,
                optimizer="adam", stream_every=1)
    sp = pbatch.BatchedTransferJob(contents, styles, Config(**base),
                                   params=vgg_params, mesh=cpu_mesh(4, 2),
                                   shard_space=True)
    assert len(sp.shards) == 4 and all(len(s.space) == 2
                                       for s in sp.shards)
    ours = np.asarray(list(sp.run(yield_images=False))[-1][2])
    one = pbatch.BatchedTransferJob(contents, styles, Config(**base),
                                    params=vgg_params, device="cpu")
    plain = np.asarray(list(one.run(yield_images=False))[-1][2])
    cons = jbatch.BatchedTransferJob(contents, styles, JConfig(**base),
                                     params=vgg_params,
                                     mesh=jjobs_space_mesh(4, 2),
                                     shard_space=True)
    assert cons.cfg.pool_impl == "reshape"  # its constrained path
    x = jnp.array(cons._x0, copy=True)
    st = cons._init_fn(cons.params, cons.targets, x)
    _x, _st, f_cons = cons._chunk_fn(cons.params, cons.targets, x, st,
                                     jnp.int32(0), 1)
    np.testing.assert_allclose(ours, np.asarray(f_cons), rtol=1e-4)
    np.testing.assert_allclose(ours, plain, rtol=1e-5)


def test_space_batch_reruns_bit_equal_at_highest(jobs64, vgg_params):
    """Two runs of one space batch at conv_precision='highest' give the
    same bits (the backward runs on autograd's threads, under the same
    process-wide cuDNN switches); graphs=True on a space batch raises."""
    contents, styles = jobs64
    cfg = Config(levels_num=1, iters_num=2, base_diameter=64,
                 optimizer="adam", stream_every=1,
                 conv_precision="highest")

    def run():
        return list(pbatch.BatchedTransferJob(
            contents[:2], styles[:2], cfg, params=vgg_params,
            mesh=cpu_mesh(1, 2), shard_space=True).run())[-1]

    a, b = run(), run()
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[2], b[2])
    with pytest.raises(ValueError, match="eagerly"):
        pbatch.BatchedTransferJob(contents[:1], styles[:1], cfg,
                                  params=vgg_params, mesh=cpu_mesh(1, 2),
                                  shard_space=True, graphs=True)


def _quadratic(a, b):
    """loss_grad of f(x) = sum a x^2 / 2 + b x per lane, for plain lanes
    and for SpaceLanes (per block, summed in shard order)."""
    def loss_grad(x):
        if isinstance(x, SpaceLanes):
            aa, bb = SpaceLanes.split(a, x.devices), SpaceLanes.split(
                b, x.devices)
            g = aa * x + bb
            return (0.5 * (aa * x * x) + bb * x).sum(dim=1), g
        return (0.5 * a * x * x + b * x).sum(dim=1), a * x + b
    return loss_grad


@pytest.mark.parametrize("direction,dtype,grams", [
    ("matrix", "float32", False), ("matrix", "float32", True),
    ("matrix", "bfloat16", True), ("loop", "float32", False)])
def test_lbfgs_lane_forms_over_space_lanes(rng, direction, dtype, grams):
    """lane_init_state and lane_lbfgs_step over a SpaceLanes of 4 blocks
    against plain (B, n) tensors on a quadratic: 4 steps, each lane's
    state (history, rho, the carried Grams, x, f) within rtol 1e-5 (the
    contractions sum the blocks in shard order)."""
    b_, n = 3, 64
    a = torch.from_numpy(rng.uniform(0.5, 5.0, (b_, n)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((b_, n)).astype(np.float32))
    x0 = torch.from_numpy(rng.standard_normal((b_, n)).astype(np.float32))
    fn = _quadratic(a, b)
    runs = []
    for x in (x0.clone(), SpaceLanes.split(x0, ["cpu"] * 4)):
        state = lbfgs.lane_init_state(fn, x, 3, track_grams=grams,
                                      state_dtype=dtype)
        for _ in range(4):
            x, state = lbfgs.lane_lbfgs_step(
                fn, x, state, np.full((b_,), 1.0, np.float32),
                direction_impl=direction, t_init="unit")
        runs.append((x, state))
    (x_p, s_p), (x_s, s_s) = runs
    assert isinstance(x_s, SpaceLanes)
    np.testing.assert_allclose(x_s.cpu().numpy(), x_p.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(s_s.count, s_p.count)
    np.testing.assert_allclose(s_s.f, s_p.f, rtol=1e-5)
    for name, leaf in lbfgs.state_leaves(s_p).items():
        ours = lbfgs.state_leaves(s_s)[name]
        ours = ours.cpu() if isinstance(ours, SpaceLanes) else ours
        np.testing.assert_allclose(ours.float().numpy(),
                                   leaf.float().numpy(), rtol=1e-4,
                                   atol=1e-4 * float(leaf.float().abs().max()
                                                     + 1e-30))


def test_space_lbfgs_batch_matches_unsharded(jobs64, vgg_params):
    """One unit L-BFGS step with carried Grams (history 2) of a space
    batch (jobs_space_mesh(2, 2)) against the unsharded batch: the first
    step's losses within rtol 1e-5, and every state leaf within its
    tolerance: the step and the point (s, x) 1e-5, rho and the Grams 1e-3
    (y . s of two near gradients), and the gradient at the new point, and
    y = g_new - g, 1e-2 in L2 (the new point's 1e-7 differences move the
    gradient through ReLU and pool kinks)."""
    contents, styles = jobs64
    cfg = Config(levels_num=1, iters_num=1, base_diameter=64,
                 stream_every=1, **SPACE_LBFGS)
    sp = pbatch.BatchedTransferJob(contents, styles, cfg, params=vgg_params,
                                   mesh=cpu_mesh(2, 2), shard_space=True)
    one = pbatch.BatchedTransferJob(contents, styles, cfg,
                                    params=vgg_params, device="cpu")
    states = []
    for job in (sp, one):
        x = job._x0.clone()
        opt = job.init_opt(x)
        x, f = job._steps(x, opt, 0, 1)
        states.append((x.cpu(), f.cpu() if hasattr(f, "cpu") else f,
                       opt.leaves()))
    (xs, fs, ls), (xp, fp, lp) = states
    np.testing.assert_allclose(np.asarray(fs), np.asarray(fp), rtol=1e-5)
    np.testing.assert_allclose(xs.numpy(), xp.numpy(), rtol=0,
                               atol=1e-5 * float(xp.abs().max()))
    tol = {"s_hist": 1e-5, "f": 1e-5, "rho": 1e-3, "sy_gram": 1e-3,
           "yy_gram": 1e-3}
    for name, leaf in lp.items():
        ours = ls[name].cpu() if hasattr(ls[name], "cpu") else ls[name]
        if name in ("count", "n_evals", "n_iter"):
            np.testing.assert_array_equal(ours.numpy(), leaf.numpy())
        elif name in tol:
            assert _rel(ours, leaf) <= tol[name], name
        else:  # y_hist, g
            rel = float((ours.double() - leaf.double()).norm()
                        / leaf.double().norm())
            assert rel <= 1e-2, (name, rel)


def _black_lanes():
    """Four one-level 64 px jobs whose contents are their init images;
    lanes 0 and 1 black (loss and gradient 0: they latch at the second
    check), after tests/test_torch_mesh.py's."""
    rng = np.random.default_rng(5)
    c2, c3, s2, s3 = rng.random((4, 64, 64, 3)).astype(np.float32)
    black = np.zeros_like(c2)
    cs = [black, black, c2, c3]
    return cs, [black, black, s2, s3], cs


def test_space_lbfgs_batch_shrinks_like_unsharded(vgg_params, capsys):
    """A unit L-BFGS space batch on jobs_space_mesh(2, 2) (after
    tests/test_parallel.py:727-765): the two black lanes latch at step 2
    and leave, the batch re-forms 4 -> 2 lanes, one a space row, so a lane
    moves to the other row with its blocks; the same lanes converge as in
    the unsharded batch, frozen losses stay, survivors keep falling."""
    cs, ss, inits = _black_lanes()
    cfg = Config(levels_num=1, iters_num=4, base_diameter=64,
                 stream_every=1, stop_tol=1e-4, stop_shrink=True,
                 **SPACE_LBFGS)
    runs = []
    for kw in (dict(mesh=cpu_mesh(2, 2), shard_space=True),
               dict(device="cpu")):
        b = pbatch.BatchedTransferJob(cs, ss, cfg, params=vgg_params,
                                      init_overrides=inits, **kw)
        out = list(b.run())
        runs.append((out, capsys.readouterr().err))
    (ours, err), (plain, err_p) = runs
    assert "batch 4 -> 2" in err and "batch 4 -> 2" in err_p
    assert [d for d, _i, _l in ours] == [d for d, _i, _l in plain]
    last, at2 = ours[-1][2], ours[1][2]
    assert (last[:2] == at2[:2]).all()
    assert (last[2:] < at2[2:]).all()
    np.testing.assert_allclose(ours[1][2][2:], plain[1][2][2:], rtol=1e-4)


@pytest.mark.parametrize("opt", ["adam", "lbfgs"])
def test_space_checkpoint_round_trips_with_unsharded(jobs64, vgg_params,
                                                     tmp_path, opt):
    """A space batch's file holds the unsharded layout: an unsharded
    batch resumes from it, a space batch from an unsharded batch's file,
    and each layout from its own file bit for bit. The leaves an
    optimizer loads are the file's, bit for bit, on either layout; after
    a change of layout Adam ends within rtol 1e-5 of the uninterrupted
    run, and L-BFGS (whose line search can branch on last bits) with
    finite losses below the step-2 ones."""
    contents, styles = jobs64
    kw = (dict(optimizer="adam") if opt == "adam"
          else dict(SPACE_LBFGS, lbfgs_history=3))
    cfg = Config(levels_num=1, iters_num=4, base_diameter=64,
                 stream_every=1, **kw)
    specs = (pbatch._Adam if opt == "adam" else pbatch._Lbfgs).leaf_specs(
        cfg, 2, 64 * 64 * 3)

    def batch(sharded):
        return pbatch.BatchedTransferJob(
            contents[:2], styles[:2], cfg, params=vgg_params,
            **(dict(mesh=cpu_mesh(1, 2), shard_space=True) if sharded
               else dict(device="cpu")))

    full = {s: list(batch(s).run())[-1] for s in (True, False)}
    for first in (True, False):
        path = str(tmp_path / f"{first}.npz")
        at2 = list(batch(first).run(iters_num=2, checkpoint_path=path,
                                    checkpoint_every=2))[-1]
        x_saved, leaves, step = ckpt.load_checkpoint(path, specs)
        assert step == 2
        for second in (True, False):
            b = batch(second)
            loaded = b.init_opt(b._place(x_saved), leaves).leaves()
            for name, leaf in leaves.items():
                got = loaded[name]
                got = got.cpu() if hasattr(got, "cpu") else got
                np.testing.assert_array_equal(got.float().numpy(),
                                              leaf.float().numpy())
            run_path = str(tmp_path / f"{first}_{second}.npz")
            shutil.copy(path, run_path)
            _d, imgs, losses = list(b.run(checkpoint_path=run_path,
                                          checkpoint_every=100,
                                          resume=True))[-1]
            if second == first:
                np.testing.assert_array_equal(imgs, full[first][1])
                np.testing.assert_array_equal(losses, full[first][2])
            elif opt == "adam":
                np.testing.assert_allclose(losses, full[first][2],
                                           rtol=1e-5)
            else:
                assert np.isfinite(losses).all()
                assert (losses < at2[2]).all()


def test_memory_stats_per_shard():
    """memory_stats at S = 2 against no space (after tests/
    test_parallel.py's test_space_sharding_memory_ratio): each shard
    saves under 0.75x the unsharded activations and holds under 0.6x its
    images and optimizer state; the state splits exactly, the scalars on
    the first shard."""
    cfg = Config(levels_num=2, optimizer="adam", base_diameter=64,
                 iters_num=4)
    one = pmemory.memory_stats(cfg, (128, 192), 1, device="cpu")
    sp = pmemory.memory_stats(cfg, (128, 192), 1, mesh=cpu_mesh(1, 2),
                              shard_space=True)
    assert sp["space_axis"] == 2 and len(sp["per_shard"]) == 2
    for shard in sp["per_shard"]:
        assert (shard["saved_activation_bytes"]
                < 0.75 * one["saved_activation_bytes"])
        assert shard["state_bytes"] < 0.6 * one["state_bytes"]
    assert (sum(s["state_bytes"] for s in sp["per_shard"])
            == one["state_bytes"])
    assert sp["predicted_bytes"] == max(s["predicted_bytes"]
                                        for s in sp["per_shard"])


def test_queue_cli_space_flag(tmp_path, monkeypatch):
    """queue_cli --space 2 (with --mesh auto) runs its queue through
    run_job_queue with shard_space on default_serving_mesh(2), here a CPU
    mesh; --space 2 with --mesh none exits with an error."""
    import artstyletransfer_tpu_torch.parallel as parallel_pkg
    from artstyletransfer_tpu_torch.frontends.queue_cli import main
    from artstyletransfer_tpu_torch.parallel import mesh as mesh_mod
    from artstyletransfer_tpu_torch.utils.image import save_image

    img = str(tmp_path / "a.png")
    save_image(np.random.default_rng(0).random((64, 64, 3)).astype(
        np.float32), img)
    seen = []
    real = pbatch.run_job_queue

    def queue(*a, **kw):
        seen.append((kw["mesh"].shape, kw["shard_space"]))
        return real(*a, **kw)

    monkeypatch.setattr(parallel_pkg, "run_job_queue", queue)
    monkeypatch.setattr(mesh_mod, "serving_mesh",
                        lambda device, n=1: cpu_mesh(1, n))
    flags = ["--pair", img, img, "--output-dir", str(tmp_path / "out"),
             "--quiet", "--levels", "1", "--iters", "1",
             "--base-diameter", "64", "--optimizer", "adam",
             "--device", "cpu"]
    assert main(flags + ["--space", "2"]) == 0
    assert seen == [({"jobs": 1, "space": 2}, True)]
    assert (tmp_path / "out" / "a__a.jpg").exists()
    with pytest.raises(SystemExit):
        main(flags + ["--space", "2", "--mesh", "none"])


# ---- the one-card path -----------------------------------------------------


def test_tv_seam_arguments_default_to_the_whole_image(rng):
    """tv and tv_bwd without h_total and a halo, or with h_total = h, give
    the whole-image functions' bits (their plain versions on the CPU);
    the space path's pieces leave the one-card forms alone."""
    y = torch.from_numpy((rng.standard_normal((2, 7, 9, 3)) * 50)
                         .astype(np.float32))
    g = torch.tensor([0.5, 2.0])
    tv, means = ktv.tv(y)
    for args in ((), (7,), (None, None)):
        tv2, means2 = ktv.tv(y, *args)
        assert torch.equal(tv, tv2) and torch.equal(means, means2)
        assert torch.equal(ktv.tv_bwd(y, g, means),
                           ktv.tv_bwd(y, g, means, *args))
    sums = ktv.tv_sums_plain(y)
    assert torch.equal(sums, ktv.tv_sums_plain(y, None))
    with pytest.raises(ValueError, match="h_total"):
        ktv._seam_args(y, 3, None, "tv")
