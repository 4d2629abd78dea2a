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
