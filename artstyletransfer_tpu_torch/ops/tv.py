"""Total-variation op: thin dispatch onto kernels/tv.py.

The reference's non-standard squared TV (reference math_utils.py:37-41):
(mean |dx|)^2 + (mean |dy|)^2 of an NHWC image. ``lane_total_variation``
takes it per image of a batch, (B,) values, as the JAX package's
``tv_pallas`` under ``jax.vmap`` (each lane a batch of one); it is the
form the engine runs, through LaneTvFn, the counterpart of ``_tv_impl``:
one forward kernel launch (means and squares) and one backward kernel
launch for every lane on a CUDA tensor, the plain versions on the CPU.
``total_variation`` takes it over the whole batch, as the JAX function
does unmapped, through TvMeansFn (the forward kernel's sums, a plain
backward); engine/builders.py's LossBuilder runs it.

At tied neighbours the gradient takes sign(0) = 0, as ``tv_pallas``'s
hand-written VJP and the reference's ``torch.abs`` do. The JAX package's
default path differentiates the XLA ``total_variation`` with JAX
autodiff, whose d|x|/dx at 0 is 1, so the two differ wherever two
neighbours are equal (a deliberate divergence:
tests/test_torch_tv_ties.py).
"""

from __future__ import annotations

import torch

from ..kernels import tv as ktv


class LaneTvFn(torch.autograd.Function):
    """(B,) squared-mean TV of an NHWC batch, each lane on its own."""

    @staticmethod
    def forward(ctx, y: torch.Tensor) -> torch.Tensor:
        y = y.contiguous()
        tv, means = ktv.tv(y)
        ctx.save_for_backward(y, means)
        return tv

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        y, means = ctx.saved_tensors
        return ktv.tv_bwd(y, g, means)


class TvMeansFn(torch.autograd.Function):
    """(B, 2) per-lane (mean |dx|, mean |dy|) of an NHWC batch, through the
    plain backward (total_variation's)."""

    @staticmethod
    def forward(ctx, y: torch.Tensor) -> torch.Tensor:
        _, h, w, c = y.shape
        ctx.save_for_backward(y)
        sums = ktv.tv_lane_sums(y.contiguous())       # (B, 2)
        return torch.stack([sums[:, 0] / (h * (w - 1) * c),
                            sums[:, 1] / ((h - 1) * w * c)], dim=1)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (y,) = ctx.saved_tensors
        kx = g[:, 0].reshape(-1, 1, 1, 1)
        ky = g[:, 1].reshape(-1, 1, 1, 1)
        return kx * ktv._dx_part(y) + ky * ktv._dy_part(y)


def lane_total_variation(y: torch.Tensor) -> torch.Tensor:
    """y: NHWC float32 batch of B lanes. Returns the (B,) squared-mean TV
    of each image on its own."""
    return LaneTvFn.apply(y)


def total_variation(y: torch.Tensor) -> torch.Tensor:
    """y: NHWC float32 batch. Returns scalar (mean|dx|)^2 + (mean|dy|)^2,
    the means taken over the whole batch."""
    mx, my = TvMeansFn.apply(y).mean(dim=0)
    return mx * mx + my * my
