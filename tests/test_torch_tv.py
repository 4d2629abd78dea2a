"""The TV forward and backward of the port (kernels/tv.py, ops/tv.py) on
the CPU: the plain versions against the JAX package's `_tv_impl`
(tv_pallas in interpret mode, vmapped over the lanes) and its VJP, the
autograd Function's graph, the launch plan, and the kernels' work split
replayed in numpy: each warp's segment of columns and strip of rows, with
the lane shuffles of csrc/tv.cu as shifts along the lane axis.

The CUDA kernels themselves run only on the card: chip_smoke.py builds
them and holds each against these same plain versions there.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from artstyletransfer_tpu.ops.pallas_kernels import _tv_means, tv_pallas
from artstyletransfer_tpu_torch.kernels import tv as ktv
from artstyletransfer_tpu_torch.ops.tv import LaneTvFn, lane_total_variation

SHAPES = [(3, 9, 13, 3), (2, 2, 5, 3), (1, 24, 40, 3), (2, 2, 2, 3)]
H100_SMS = 132


def _vmapped(fn):
    return jax.vmap(lambda yi: fn(yi[None]))


@pytest.mark.parametrize("shape", SHAPES)
def test_tv_plain_matches_vmapped_pallas(rng, shape):
    """tv_plain's (B,) TV and (B, 2) means against tv_pallas and _tv_means
    (interpret) per lane: rtol 1e-5 for float32 sums in other orders."""
    y = (rng.standard_normal(shape) * 50).astype(np.float32)
    tv, means = ktv.tv_plain(torch.from_numpy(y))
    ref_tv = np.asarray(_vmapped(lambda yi: tv_pallas(yi, interpret=True))(
        jnp.asarray(y)))
    ref_means = np.stack([np.asarray(m) for m in _vmapped(
        lambda yi: _tv_means(yi, True))(jnp.asarray(y))], axis=1)
    assert tv.shape == (shape[0],) and means.shape == (shape[0], 2)
    np.testing.assert_allclose(tv.numpy(), ref_tv, rtol=1e-5)
    np.testing.assert_allclose(means.numpy(), ref_means, rtol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_tv_bwd_plain_matches_pallas_vjp(rng, shape):
    """tv_bwd_plain(y, g, means) against the VJP of tv_pallas (interpret,
    its custom `_tv_vjp_bwd`) under jax.vmap, with a distinct cotangent per
    lane: rtol 1e-5, atol 1e-7 (the same signs times scalars rounded in
    another order)."""
    y = (rng.standard_normal(shape) * 50).astype(np.float32)
    g = rng.uniform(0.5, 2.0, shape[0]).astype(np.float32)
    _, vjp = jax.vjp(_vmapped(lambda yi: tv_pallas(yi, interpret=True)),
                     jnp.asarray(y))
    ref = np.asarray(vjp(jnp.asarray(g))[0])
    yt = torch.from_numpy(y)
    _, means = ktv.tv_plain(yt)
    ours = ktv.tv_bwd_plain(yt, torch.from_numpy(g), means)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-7)


def test_lane_tv_is_one_graph_node(rng):
    """lane_total_variation's output hangs off one LaneTvFn node, which
    leads straight to y: one node carries each direction, and its backward
    matches the plain backward bit for bit."""
    y = torch.from_numpy((rng.standard_normal((2, 6, 7, 3)) * 50)
                         .astype(np.float32)).requires_grad_(True)
    tv = lane_total_variation(y)
    node = tv.grad_fn
    assert isinstance(node, LaneTvFn._backward_cls)
    (leaf, _), = node.next_functions
    assert type(leaf).__name__ == "AccumulateGrad" and leaf.variable is y
    g = torch.tensor([0.5, 3.0])
    tv.backward(g)
    _, means = ktv.tv_plain(y.detach())
    assert torch.equal(y.grad, ktv.tv_bwd_plain(y.detach(), g, means))


def _lanes(v, q):
    """v shifted down the lane axis by q (lane l reads lane l + q), as
    __shfl_down_sync; lanes past the warp keep their own value."""
    out = v.copy()
    if 0 < q < 32:
        out[..., :32 - q, :] = v[..., q:, :]
    return out


def _lanes_up(v, q):
    """Lane l reads lane l - q (__shfl_up_sync)."""
    out = v.copy()
    if 0 < q < 32:
        out[..., q:, :] = v[..., :32 - q, :]
    return out


def _pick(a, b, i, vec):
    return a[..., i] if i < vec else b[..., i - vec]


def _segment(img, r, j0, vec):
    """(32, vec) values of row r at lanes' columns j0 (0 out of the row)."""
    W = img.shape[1]
    v = np.zeros((32, vec), np.float64)
    for lane in range(32):
        if 0 <= j0[lane] < W:
            v[lane] = img[r, j0[lane]:j0[lane] + vec]
    return v


def _replay_fwd(img, c, plan):
    """csrc/tv.cu's tv_fwd_kernel for one (h, W) image, unit by unit:
    (sum_x, sum_y) and how often each pair was counted."""
    h, W = img.shape
    vec, rows = plan["vec"], plan["fwd_rows"]
    q0, cr = divmod(c, vec)
    halo = -(-c // vec)
    seg_cols = (32 - halo) * vec
    nseg = -(-W // seg_cols)
    lanes = np.arange(32)
    sx = sy = 0.0
    hits_x = np.zeros((h, W), int)
    hits_y = np.zeros((h, W), int)
    for u in range(nseg * -(-h // rows)):
        strip, seg = divmod(u, nseg)
        j0 = seg * seg_cols + lanes * vec
        mine = (lanes < 32 - halo) & (j0 < W)
        r0, r1 = strip * rows, min(strip * rows + rows, h)
        prev = None
        for r in range(r0, min(r1, h - 1) + 1):
            v = _segment(img, r, j0, vec)
            if r > r0:
                for lane in lanes[mine]:
                    sy += np.abs(prev[lane] - v[lane]).sum()
                    hits_y[r - 1, j0[lane]:j0[lane] + vec] += 1
            if r < r1:
                a, b = _lanes(v, q0), _lanes(v, q0 + 1)
                for k in range(vec):
                    nb = _pick(a, b, k + cr, vec)
                    for lane in lanes[mine]:
                        j = j0[lane] + k
                        if j + c < W:
                            assert nb[lane] == img[r, j + c]
                            sx += abs(v[lane, k] - nb[lane])
                            hits_x[r, j] += 1
            prev = v
    return sx, sy, hits_x, hits_y


def _replay_bwd(img, c, plan, ax, ay):
    """csrc/tv.cu's tv_bwd_kernel for one image: the grad and how often
    each element was written."""
    h, W = img.shape
    vec, rows = plan["vec"], plan["bwd_rows"]
    q0, cr = divmod(c, vec)
    halo = -(-c // vec)
    seg_cols = (32 - 2 * halo) * vec
    nseg = -(-W // seg_cols)
    lanes = np.arange(32)
    grad = np.zeros((h, W))
    hits = np.zeros((h, W), int)
    for u in range(nseg * -(-h // rows)):
        strip, seg = divmod(u, nseg)
        j0 = seg * seg_cols + (lanes - halo) * vec
        mine = (lanes >= halo) & (lanes < 32 - halo) & (j0 >= 0) & (j0 < W)
        r0, r1 = strip * rows, min(strip * rows + rows, h)
        up = _segment(img, r0 - 1, j0, vec) if r0 > 0 else np.zeros((32, vec))
        cur = _segment(img, r0, j0, vec)
        for r in range(r0, r1):
            dn = _segment(img, r + 1, j0, vec) if r + 1 < h else np.zeros(
                (32, vec))
            a, b = _lanes(cur, q0), _lanes(cur, q0 + 1)
            la, lb = _lanes_up(cur, q0 + 1), _lanes_up(cur, q0)
            for k in range(vec):
                nr = _pick(a, b, k + cr, vec)
                nl = _pick(la, lb, k - cr + vec, vec)
                for lane in lanes[mine]:
                    j = j0[lane] + k
                    dx = dy = 0.0
                    if j + c < W:
                        assert nr[lane] == img[r, j + c]
                        dx += np.sign(cur[lane, k] - nr[lane])
                    if j >= c:
                        assert nl[lane] == img[r, j - c]
                        dx -= np.sign(nl[lane] - cur[lane, k])
                    if r + 1 < h:
                        dy += np.sign(cur[lane, k] - dn[lane, k])
                    if r > 0:
                        dy -= np.sign(up[lane, k] - cur[lane, k])
                    grad[r, j] = ax * dx + ay * dy
                    hits[r, j] += 1
            up, cur = cur, dn
    return grad, hits


@pytest.mark.parametrize("shape,vec", [
    ((9, 13, 3), 1), ((24, 40, 3), 4), ((2, 2, 3), 2), ((2, 5, 3), 1),
    ((7, 50, 1), 2), ((5, 30, 2), 2), ((33, 43, 3), 1), ((6, 12, 4), 4),
    ((3, 20, 4), 1)])
def test_tv_kernels_work_split_replayed(rng, shape, vec):
    """Both kernels' decomposition replayed in numpy (float64): the forward
    counts every horizontal and vertical pair once and its sums match the
    plain version's; the backward writes every element once and its grad
    matches tv_bwd_plain. Both at the planned strips and at strips of 1
    and 3 rows (ragged last strips)."""
    h, w, c = shape
    img = np.round(rng.standard_normal((h, w * c)) * 4)  # ties included
    yt = torch.from_numpy(img.reshape(1, h, w, c))
    base = ktv.launch_plan(1, h, w, c, H100_SMS, 7, vec)
    for rows in (None, 1, 3):
        plan = dict(base) if rows is None else dict(base, fwd_rows=rows,
                                                    bwd_rows=rows)
        sx, sy, hits_x, hits_y = _replay_fwd(img, c, plan)
        assert (hits_x[:, :w * c - c] == 1).all() and hits_x[:, w * c - c:].sum() == 0
        assert (hits_y[:-1] == 1).all() and hits_y[-1].sum() == 0
        np.testing.assert_allclose([sx, sy], ktv.tv_sums_plain(yt)[0].numpy(),
                                   rtol=1e-12)
        g = torch.tensor([1.5], dtype=torch.float64)
        _, means = ktv.tv_plain(yt)
        nx, ny = h * (w - 1) * c, (h - 1) * w * c
        grad, hits = _replay_bwd(img, c, plan, float(g * 2 * means[0, 0] / nx),
                                 float(g * 2 * means[0, 1] / ny))
        assert (hits == 1).all()
        np.testing.assert_allclose(
            grad, ktv.tv_bwd_plain(yt, g, means)[0].reshape(h, w * c).numpy(),
            rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("lanes,h,w", [(1, 512, 512), (1, 256, 256),
                                       (8, 512, 512), (6, 256, 256),
                                       (2, 512, 682), (1, 511, 769),
                                       (40, 64, 64)])
def test_tv_launch_plan(lanes, h, w):
    """The launch plan on an H100 (132 SMs): one cluster per lane, of 16
    blocks while the lanes' clusters all fit the card at once (7 such
    clusters here), else 8; forward blocks of at most 1024 threads whose
    warps cover every unit of work in one pass, strips of at least 8 rows
    where the warps allow; backward strips of 4 to 32 rows."""
    vec = ktv.vec_width(w, 3)
    plan = ktv.launch_plan(lanes, h, w, 3, H100_SMS, 7, vec)
    assert plan["vec"] == {0: 4, 2: 2}.get((w * 3) % 4, 1)
    assert plan["cluster"] == (16 if lanes <= 7 else 8)
    assert 1 <= plan["fwd_warps"] <= 32
    assert plan["fwd_units"] <= plan["cluster"] * plan["fwd_warps"] or (
        plan["fwd_warps"] == 32 and plan["fwd_rows"] == 8)
    assert plan["fwd_rows"] >= min(8, h) or plan["fwd_warps"] == 32
    assert 4 <= plan["bwd_rows"] <= 32
    assert plan["bwd_blocks"] * plan["bwd_warps"] >= plan["bwd_units"]
    assert ktv.launch_plan(lanes, h, w, 3, H100_SMS, 0, vec)["cluster"] == 8


def test_vec_width_follows_row_alignment():
    assert ktv.vec_width(512, 3) == 4
    assert ktv.vec_width(682, 3) == 2
    assert ktv.vec_width(769, 3) == 1
    assert ktv.vec_width(512, 3, data_ptr=8) == 2
    with pytest.raises(ValueError):
        ktv.launch_plan(1, 4, 5, 3, H100_SMS, 7, 4)


def test_tv_wrappers_refuse_without_fallback():
    """No fallback: the CUDA entry points refuse a CPU tensor, the
    dispatchers a tensor that is neither on the CPU nor on CUDA."""
    y = torch.zeros((1, 4, 4, 3))
    g, means = torch.ones(1), torch.ones((1, 2))
    with pytest.raises(ValueError):
        ktv.tv_cuda(y)
    with pytest.raises(ValueError):
        ktv.tv_bwd_cuda(y, g, means)
    meta = torch.empty((1, 4, 4, 3), device="meta")
    with pytest.raises(ValueError):
        ktv.tv(meta)
    with pytest.raises(ValueError):
        ktv.tv_bwd(meta, g, means)
    with pytest.raises(ValueError):
        ktv.tv_lane_sums(meta)
