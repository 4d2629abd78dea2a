"""The port's kernel wrappers on the CPU (their plain versions) against the
JAX package's Pallas kernels run in interpret mode.

The CUDA kernels themselves run only on the card: chip_smoke.py builds
them and holds each against these same plain versions there.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from artstyletransfer_tpu.ops.pallas_kernels import (
    _gram_bwd_impl,
    gram_pallas,
    tv_pallas,
)
from artstyletransfer_tpu_torch.kernels import LAUNCHES, reset_launches
from artstyletransfer_tpu_torch.kernels import gram as kgram
from artstyletransfer_tpu_torch.kernels import tv as ktv
from artstyletransfer_tpu_torch.kernels.lbfgs import two_loop_coefficients
from artstyletransfer_tpu_torch.ops.conv_relu import conv3x3_relu
from artstyletransfer_tpu_torch.ops.gram import gram_matrix
from artstyletransfer_tpu_torch.ops.tv import (lane_total_variation,
                                               total_variation)


def _bf16(a: np.ndarray) -> np.ndarray:
    """Round float32 values to bfloat16 and back, so both frameworks see
    the same bf16 inputs."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


# f32: both sides accumulate the same products in float32 in different
# orders — relative error of a few ulps times sqrt(n)
@pytest.mark.parametrize("c", [64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gram_plain_matches_pallas(rng, c, dtype):
    x = rng.standard_normal((1, 16, 24, c)).astype(np.float32)
    if dtype == "bfloat16":
        x = _bf16(x)
    ref = np.asarray(gram_pallas(jnp.asarray(x, dtype=dtype), True, True))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    ours = gram_matrix(xt).numpy()
    assert ours.dtype == np.float32 and ours.shape == (1, c, c)
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("c", [64, 128])
def test_gram_grad_matches_pallas(rng, c):
    """The Gram's autograd backward (the Gram-backward plain version with
    g_sym = s(G_bar + G_bar^T)) against jax.grad through gram_pallas
    (whose VJP runs _gram_bwd_kernel in interpret mode); rtol 1e-4 as in
    tests/test_pallas_kernels.py."""
    x = rng.standard_normal((1, 8, 16, c)).astype(np.float32)
    target = rng.standard_normal((1, c, c)).astype(np.float32)

    def loss_jax(x):
        return jnp.mean(jnp.square(gram_pallas(x, True, True) - target))

    g_ref = np.asarray(jax.grad(loss_jax)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    loss = torch.mean(torch.square(gram_matrix(xt) - torch.from_numpy(target)))
    loss.backward()
    np.testing.assert_allclose(xt.grad.numpy(), g_ref, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("c", [64, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gram_bwd_plain_matches_pallas(rng, c, dtype):
    """dF = F @ g_sym against _gram_bwd_impl(interpret=True). bf16: the
    plain version rounds dF to bf16 (like _gram_vjp_bwd's cast), so the
    tolerance is one bf16 ulp (2^-8 relative)."""
    f = rng.standard_normal((1, 8, 16, c)).astype(np.float32)
    if dtype == "bfloat16":
        f = _bf16(f)
    g = rng.standard_normal((1, c, c)).astype(np.float32)
    ref = np.asarray(_gram_bwd_impl(jnp.asarray(f), jnp.asarray(g),
                                    interpret=True))[0]
    ft = torch.from_numpy(f.reshape(-1, c)).to(getattr(torch, dtype))
    ours = kgram.gram_bwd(ft, torch.from_numpy(g[0]))
    assert ours.dtype == ft.dtype and ours.shape == (8 * 16, c)
    if dtype == "float32":
        np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-4)
    else:
        np.testing.assert_allclose(ours.float().numpy(), ref, rtol=2 ** -8,
                                   atol=1e-2)


@pytest.mark.parametrize("shape", [(1, 24, 40, 3), (1, 32, 32, 3),
                                   (2, 9, 13, 3)])
def test_tv_plain_matches_pallas(rng, shape):
    """Squared-mean TV against tv_pallas(interpret=True), one image at a
    time for a batch (the TPU kernel takes batch 1): rtol 1e-5 for float32
    sums taken in different orders."""
    y = rng.standard_normal(shape).astype(np.float32) * 50
    ours = float(total_variation(torch.from_numpy(y)))
    if shape[0] == 1:
        ref = float(tv_pallas(jnp.asarray(y), interpret=True))
        np.testing.assert_allclose(ours, ref, rtol=1e-5)
    sx, sy = ktv.tv_sums(torch.from_numpy(y))
    b, h, w, c = shape
    ref_sx = np.abs(np.diff(y, axis=2)).sum(dtype=np.float64)
    ref_sy = np.abs(np.diff(y, axis=1)).sum(dtype=np.float64)
    np.testing.assert_allclose(float(sx), ref_sx, rtol=1e-5)
    np.testing.assert_allclose(float(sy), ref_sy, rtol=1e-5)


def test_tv_grad_matches_pallas(rng):
    y = rng.standard_normal((1, 12, 16, 3)).astype(np.float32)
    g_ref = np.asarray(jax.grad(lambda y: tv_pallas(y, interpret=True))(
        jnp.asarray(y)))
    yt = torch.from_numpy(y).requires_grad_(True)
    total_variation(yt).backward()
    np.testing.assert_allclose(yt.grad.numpy(), g_ref, rtol=1e-4, atol=1e-6)


def test_cpu_runs_are_not_counted_as_launches(rng):
    reset_launches()
    x = torch.from_numpy(rng.standard_normal((1, 4, 4, 64)).astype(np.float32))
    gram_matrix(x)
    total_variation(x[..., :3].contiguous())
    y = x[..., :3].contiguous().requires_grad_(True)
    lane_total_variation(y).sum().backward()
    assert y.grad is not None
    conv3x3_relu(x, torch.zeros((3, 3, 64, 8)), torch.zeros((8,)))
    m = 4
    two_loop_coefficients(torch.zeros((1, m, m)), torch.zeros((1, m, m)),
                          torch.ones((1, m)), torch.ones((1, m)),
                          torch.ones((1, m)), torch.tensor([2]))
    assert LAUNCHES == {"gram": 0, "gram_bwd": 0, "tv": 0, "tv_bwd": 0,
                        "conv_relu": 0, "lbfgs_coef": 0, "vgg_glue": 0,
                        "vgg_glue_bwd": 0}


def test_wrappers_refuse_other_devices():
    """No fallback: a tensor that is neither on the CPU nor on CUDA, or a
    CPU tensor handed to a kernel entry point, raises."""
    meta = torch.empty((64, 64), device="meta")
    with pytest.raises(ValueError):
        kgram.gram(meta, 1.0)
    with pytest.raises(ValueError):
        kgram.gram_bwd(meta, meta)
    with pytest.raises(ValueError):
        ktv.tv_sums(torch.empty((1, 4, 4, 3), device="meta"))
    with pytest.raises(ValueError):
        kgram.gram_cuda(torch.zeros((64, 64)), 1.0)
    with pytest.raises(ValueError):
        ktv.tv_cuda(torch.zeros((1, 4, 4, 3)))


def test_gram_split_plan_covers_rows():
    """The forward's row split on an H100 (132 SMs): every split
    non-empty, whole 32-row chunks, all rows covered; at c=64 (one tile)
    the cap of 256 splits binds at one lane and three waves of three
    blocks per SM at eight lanes."""
    for n, c in [(262144, 64), (65536, 128), (16384, 256), (4096, 512),
                 (1024, 512), (256, 512), (7, 64), (1000, 3)]:
        splits, rows = kgram.split_plan(n, c, 132)
        assert rows % 32 == 0 and splits >= 1
        assert (splits - 1) * rows < n <= splits * rows
    assert kgram.split_plan(262144, 64, 132)[0] == 256
    lanes8 = kgram.split_plan(262144, 64, 132, batch=8)[0]
    assert 8 * lanes8 <= 9 * 132 < 8 * (lanes8 + 2)


def _tf32_rna(x: np.ndarray) -> np.ndarray:
    """float32 rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero: csrc/gram_bwd.cu's split(), as a bit mask."""
    bits = x.astype(np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_trunc(x: np.ndarray) -> np.ndarray:
    """The TF32 value the tensor core reads from a float32 operand: its
    low 13 mantissa bits dropped."""
    return (x.astype(np.float32).view(np.uint32)
            & np.uint32(0xFFFFE000)).view(np.float32)


@pytest.mark.parametrize("n, c", [(4096, 512), (16384, 64)])
def test_gram_bwd_3xtf32_split_is_float32_accurate(n, c):
    """The numerical argument of csrc/gram_bwd.cu: with x = hi + lo
    (hi = tf32(x) rounded to nearest, lo = x - hi as the tensor core reads
    it), a_lo b_hi + a_hi b_lo + a_hi b_hi summed in float32 is within
    1e-5 of float64 F @ g, while a single TF32 product is not within the
    kernel's float32 tolerance of 1e-4. Inputs as chip_smoke.py draws
    them: post-ReLU F, symmetric g."""
    rng = np.random.default_rng(0)
    f = np.maximum(rng.standard_normal((n, c)), 0).astype(np.float32)
    g = (rng.standard_normal((c, c)) / (n * c)).astype(np.float32)
    g = g + g.T
    ref = f.astype(np.float64) @ g.astype(np.float64)

    def rel(out):
        return float(np.abs(out - ref).max() / np.abs(ref).max())

    f_hi, g_hi = _tf32_rna(f), _tf32_rna(g)
    f_lo, g_lo = _tf32_trunc(f - f_hi), _tf32_trunc(g - g_hi)
    three = f_lo @ g_hi + f_hi @ g_lo + f_hi @ g_hi  # float32 sums
    assert three.dtype == np.float32
    assert rel(three) <= 1e-5
    assert rel(f_hi @ g_hi) > 1e-4


@pytest.mark.parametrize("n, c", [(4096, 512), (16384, 256), (262144, 64)])
def test_gram_3xtf32_split_is_float32_accurate(n, c):
    """The numerical argument of csrc/gram.cu: the 3xTF32 partial sums of
    the wrapper's row splits (a_lo b_hi + a_hi b_lo + a_hi b_hi in float32,
    A = F^T, B = F), summed in the splits' order in float32, are within
    1e-6 of float64 F^T F; at c >= 256 a single TF32 product is not within
    1e-5, too coarse for G - Gt late in a run. Inputs as chip_smoke.py
    draws them: post-ReLU F."""
    rng = np.random.default_rng(0)
    f = np.maximum(rng.standard_normal((n, c)), 0).astype(np.float32)
    ref = f.T.astype(np.float64) @ f.astype(np.float64)

    def rel(out):
        return float(np.abs(out - ref).max() / np.abs(ref).max())

    hi = _tf32_rna(f)
    lo = _tf32_trunc(f - hi)
    splits, rows = kgram.split_plan(n, c, 132)
    three = np.zeros((c, c), np.float32)
    one = np.zeros((c, c), np.float32)
    for k in range(splits):
        h, l = hi[k * rows:(k + 1) * rows], lo[k * rows:(k + 1) * rows]
        three += l.T @ h + h.T @ l + h.T @ h
        one += h.T @ h
    assert three.dtype == np.float32
    assert rel(three) <= 1e-6
    if c >= 256:
        assert rel(one) > 1e-5
