"""The TV gradient at tied neighbours: a deliberate divergence from the
JAX package's default path, pinned.

The port's TV backward (kernels/tv.py, its plain version here; the CUDA
kernel on the card is held to the same plain version by chip_smoke.py)
takes sign(0) = 0, as ``tv_pallas``'s hand-written VJP (``_tv_vjp_bwd``)
and the reference's ``torch.abs`` do. The JAX package's default engine
path (``use_pallas=False``) differentiates the XLA ``total_variation``
with JAX autodiff, whose d|x|/dx at 0 is 1. Content images are 8-bit, so
flat regions tie exactly; on integer-valued images the two gradients
differ, and only at elements of tied pairs.
"""

import numpy as np

import jax
import jax.numpy as jnp
import torch

from artstyletransfer_tpu.ops.pallas_kernels import tv_pallas
from artstyletransfer_tpu.ops.tv import total_variation as xla_tv
from artstyletransfer_tpu_torch.ops.tv import lane_total_variation


def _vjp_per_lane(fn, y, g):
    """The VJP of fn (one NHWC image of a batch of one) under jax.vmap,
    with cotangent g[b] for lane b."""
    _, vjp = jax.vjp(jax.vmap(lambda yi: fn(yi[None])), jnp.asarray(y))
    return np.asarray(vjp(jnp.asarray(g))[0])


def _tied(y):
    """Elements that belong to a tied horizontal or vertical pair."""
    tied = np.zeros(y.shape, bool)
    dx = y[:, :, :-1] == y[:, :, 1:]
    dy = y[:, :-1] == y[:, 1:]
    tied[:, :, :-1] |= dx
    tied[:, :, 1:] |= dx
    tied[:, :-1] |= dy
    tied[:, 1:] |= dy
    return tied


def test_tv_gradient_at_ties_follows_the_pallas_vjp(rng):
    """Integer-valued (3, 8, 8, 3) images with many ties, a distinct
    cotangent per lane: the port's gradient equals jax.grad of tv_pallas
    (interpret) under vmap (rtol 1e-5, atol 1e-7), and differs from that of
    the XLA total_variation by more than 1e-3 of its largest entry
    somewhere, and only at elements of tied pairs."""
    y = rng.integers(0, 4, (3, 8, 8, 3)).astype(np.float32)
    g = np.array([1.0, 0.25, 3.0], np.float32)
    tied = _tied(y)
    assert 0.2 < tied.mean() < 1.0

    yt = torch.from_numpy(y).requires_grad_(True)
    lane_total_variation(yt).backward(torch.from_numpy(g))
    ours = yt.grad.numpy()

    pallas = _vjp_per_lane(lambda yi: tv_pallas(yi, interpret=True), y, g)
    np.testing.assert_allclose(ours, pallas, rtol=1e-5, atol=1e-7)

    xla = _vjp_per_lane(xla_tv, y, g)
    differs = ~np.isclose(ours, xla, rtol=1e-5, atol=1e-7)
    assert np.abs(ours - xla).max() > 1e-3 * np.abs(xla).max()
    assert differs.any() and not (differs & ~tied).any()
