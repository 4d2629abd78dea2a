"""The port's fused 3x3 conv + bias + ReLU (ops/conv_relu.py and the plain
version of kernels/conv_relu.py) against the JAX package's
``conv3x3_relu_pallas`` in interpret mode and its XLA twin, on the CPU.

The CUDA kernel itself runs only on the card: chip_smoke.py builds it and
holds it against the same plain version at every VGG19 conv shape there.
Tolerances: float32 convolutions summed in other orders (oneDNN, XLA, the
Pallas interpreter's nine shifted matmuls) — rtol/atol 1e-5 on the
forward as tests/test_pallas_kernels.py, 1e-4 on the gradients.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from artstyletransfer_tpu.ops.pallas_kernels import (
    _conv_relu_xla,
    conv3x3_relu_pallas,
)
from artstyletransfer_tpu_torch.kernels import LAUNCHES, reset_launches
from artstyletransfer_tpu_torch.kernels import conv_relu as kconv
from artstyletransfer_tpu_torch.ops.conv_relu import conv3x3_relu


def _inputs(rng, shape, cout):
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal((3, 3, shape[-1], cout)) * 0.1).astype(np.float32)
    b = rng.standard_normal((cout,)).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("shape,cout", [((1, 16, 24, 64), 64),
                                        ((1, 8, 16, 3), 64),
                                        ((1, 12, 8, 64), 128)])
def test_conv3x3_relu_matches_pallas(rng, shape, cout):
    x, w, b = _inputs(rng, shape, cout)
    ref = np.asarray(conv3x3_relu_pallas(jnp.asarray(x), jnp.asarray(w),
                                         jnp.asarray(b), True))
    ours = conv3x3_relu(*map(torch.from_numpy, (x, w, b)))
    assert ours.shape == shape[:3] + (cout,) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_conv3x3_relu_grad_matches_pallas(rng):
    """The backward rematerialises the plain version and differentiates it
    (as _conv_relu_vjp_bwd does the XLA twin): d sum(y^2) / d(x, w, b)
    against jax.grad through conv3x3_relu_pallas (interpret) and through
    _conv_relu_xla."""
    x, w, b = _inputs(rng, (1, 8, 16, 64), 64)
    args = tuple(map(jnp.asarray, (x, w, b)))
    g_pallas = jax.grad(
        lambda *a: jnp.sum(conv3x3_relu_pallas(*a, True) ** 2),
        argnums=(0, 1, 2))(*args)
    g_xla = jax.grad(lambda *a: jnp.sum(_conv_relu_xla(*a) ** 2),
                     argnums=(0, 1, 2))(*args)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (x, w, b)]
    (conv3x3_relu(*ts) ** 2).sum().backward()
    for t, gp, gx in zip(ts, g_pallas, g_xla):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(gp),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(gx),
                                   rtol=1e-4, atol=1e-4)


def test_conv3x3_relu_takes_any_batch_and_shape(rng):
    """Shapes the TPU kernel refuses (batch 2, H % 4 != 0, channels not
    multiples of 64) against the XLA twin."""
    x, w, b = _inputs(rng, (2, 7, 9, 5), 70)
    ref = np.asarray(_conv_relu_xla(*map(jnp.asarray, (x, w, b))))
    ours = conv3x3_relu(*map(torch.from_numpy, (x, w, b))).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)


def test_conv_relu_supported_states_the_kernel_limits():
    x = torch.zeros((2, 7, 9, 5))
    w = torch.zeros((3, 3, 5, 70))
    b = torch.zeros((70,))
    assert kconv.conv_relu_supported(x, w, b)        # any batch and shape
    assert not kconv.conv_relu_supported(x.double(), w, b)
    assert not kconv.conv_relu_supported(x, w[:, :, :4], b)
    assert not kconv.conv_relu_supported(x, w, b[:8])
    assert not kconv.conv_relu_supported(x.permute(0, 2, 1, 3), w, b)
    big = torch.empty((1, 2 ** 16, 2 ** 15, 1), device="meta")
    assert not kconv.conv_relu_supported(big, torch.empty((3, 3, 1, 1),
                                                          device="meta"),
                                         torch.empty((1,), device="meta"))


def test_conv_relu_wrappers_never_fall_back(rng):
    """A CPU tensor runs the plain version (not counted as a launch); the
    kernel's own entry point refuses it; other devices raise."""
    reset_launches()
    x, w, b = map(torch.from_numpy, _inputs(rng, (1, 4, 4, 8), 8))
    torch.testing.assert_close(kconv.conv_relu(x, w, b),
                               kconv.conv_relu_plain(x, w, b))
    assert LAUNCHES["conv_relu"] == 0
    with pytest.raises(ValueError):
        kconv.conv_relu_cuda(x, w, b)
    meta = [t.to("meta") for t in (x, w, b)]
    with pytest.raises(ValueError):
        kconv.conv_relu(*meta)


# (h = w at the 512 px level input, cin, cout) of the truncated VGG19's
# 13 convs, as chip_smoke.py's VGG_CONVS
_VGG_CONVS = [(512, 3, 64), (512, 64, 64), (256, 64, 128), (256, 128, 128),
              (128, 128, 256), (128, 256, 256), (128, 256, 256),
              (128, 256, 256), (64, 256, 512), (64, 512, 512),
              (64, 512, 512), (64, 512, 512), (32, 512, 512)]
_SMS = 132  # an H100's SMs


@pytest.mark.parametrize("images", [1, 8])
def test_conv_split_plan_covers_channels(images):
    """The tensor-core kernel's split over input channels at the 26 VGG19
    convs (512 px and 256 px level inputs): the splits' whole 16-channel
    chunks cover every input channel exactly once, every split is
    non-empty, and a grid under one wave of an H100's 132 SMs is split
    into at least one wave (the 16^2 and 32^2 convs at one image); a grid
    of a wave or more is not split."""
    for level in (1, 2):
        for size, cin, cout in _VGG_CONVS:
            h = w = size // level
            splits, per = kconv.split_plan(images, h, w, cin, cout, _SMS)
            chunks = -(-cin // 16)
            channels = [c for s in range(splits)
                        for c in range(16 * s * per,
                                       min(cin, 16 * (s + 1) * per))]
            assert channels == list(range(cin))
            assert (splits - 1) * per < chunks <= splits * per
            blocks = -(-h // 8) * -(-w // 16) * -(-cout // 64) * images
            if blocks >= _SMS:
                assert splits == 1
            else:
                assert blocks * splits >= _SMS, (h, cin, cout, splits)


def _tf32_rna(x: np.ndarray) -> np.ndarray:
    """float32 rounded to TF32, to nearest with ties away from zero
    (csrc/conv_relu.cu's split(), as a bit mask)."""
    bits = x.astype(np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000))
            & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_trunc(x: np.ndarray) -> np.ndarray:
    """The TF32 value the tensor core reads from a float32 operand."""
    return (x.astype(np.float32).view(np.uint32)
            & np.uint32(0xFFFFE000)).view(np.float32)


@pytest.mark.parametrize("hw, cin, cout", [(8, 64, 64), (16, 512, 512)])
def test_conv_3xtf32_chunk_sums_are_float32_accurate(hw, cin, cout):
    """The numerical argument of csrc/conv_relu.cu's tensor-core kernel,
    emulated in numpy: per 16-channel chunk, the nine taps' products
    x_lo w_hi + x_hi w_lo + x_hi w_hi (hi rounded to nearest TF32, lo read
    truncated) summed from zero in float32 and added to the split's sum;
    the wrapper's splits (4 and 11 here) added in order, then the bias and
    the ReLU. That is within 1e-6 of the float64 conv (float32 rounding),
    while one TF32 product per tap is not within the kernel's 1e-4.
    Inputs as chip_smoke.py draws them: post-ReLU x, He-scaled weights."""
    rng = np.random.default_rng(0)
    x = np.maximum(rng.standard_normal((hw, hw, cin)), 0).astype(np.float32)
    w = (rng.standard_normal((3, 3, cin, cout))
         * np.sqrt(2.0 / (9 * cin))).astype(np.float32).reshape(9, cin, cout)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    pad = np.pad(x, ((1, 1), (1, 1), (0, 0)))
    taps = np.stack([pad[dy:dy + hw, dx:dx + hw].reshape(hw * hw, cin)
                     for dy in range(3) for dx in range(3)])
    ref = np.maximum(np.einsum("tpc,tco->po", taps.astype(np.float64),
                               w.astype(np.float64)) + b, 0.0)

    def rel(out):
        return float(np.abs(out - ref).max() / np.abs(ref).max())

    x_hi, w_hi = _tf32_rna(taps), _tf32_rna(w)
    x_lo, w_lo = _tf32_trunc(taps - x_hi), _tf32_trunc(w - w_hi)
    splits, per = kconv.split_plan(1, hw, hw, cin, cout, _SMS)
    assert splits > 1
    total = np.zeros((hw * hw, cout), np.float32)
    one = np.zeros((hw * hw, cout), np.float32)
    for s in range(splits):
        acc = np.zeros_like(total)
        for c0 in range(16 * s * per, min(cin, 16 * (s + 1) * per), 16):
            k = slice(c0, c0 + 16)
            part = np.zeros_like(acc)
            for t in range(9):
                part += (x_lo[t][:, k] @ w_hi[t][k]
                         + x_hi[t][:, k] @ w_lo[t][k]
                         + x_hi[t][:, k] @ w_hi[t][k])
                one += x_hi[t][:, k] @ w_hi[t][k]
            acc += part
        total += acc
    assert total.dtype == np.float32
    assert rel(np.maximum(total + b, 0.0)) <= 1e-6
    assert rel(np.maximum(one + b, 0.0)) > 1e-4
