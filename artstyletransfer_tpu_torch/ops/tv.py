"""Total-variation op: thin dispatch onto kernels/tv.py.

The reference's non-standard squared TV (reference math_utils.py:37-41):
(mean |dx|)^2 + (mean |dy|)^2 of an NHWC image. ``lane_total_variation``
takes it per image of a batch, (B,) values, as the JAX package's
``total_variation`` under ``jax.vmap`` (each lane a batch of one); it is
the form the engine runs. ``total_variation`` takes it over the whole
batch, as that function does unmapped. Both square the per-lane means of
one autograd Function, whose forward sums come from the TV kernel (one
launch for every lane) on a CUDA tensor and its plain version on the CPU.
The backward is plain PyTorch, as it is XLA in the JAX package
(``_tv_vjp_bwd``): sign(0) = 0, like autodiff of |.|.
"""

from __future__ import annotations

import torch

from ..kernels import tv as ktv


def _dx_part(y: torch.Tensor) -> torch.Tensor:
    _, h, w, c = y.shape
    sx = torch.sign(y[:, :, :-1, :] - y[:, :, 1:, :]) / (h * (w - 1) * c)
    grad = torch.zeros_like(y)
    grad[:, :, :-1, :] += sx
    grad[:, :, 1:, :] -= sx
    return grad


def _dy_part(y: torch.Tensor) -> torch.Tensor:
    _, h, w, c = y.shape
    sy = torch.sign(y[:, :-1, :, :] - y[:, 1:, :, :]) / ((h - 1) * w * c)
    grad = torch.zeros_like(y)
    grad[:, :-1, :, :] += sy
    grad[:, 1:, :, :] -= sy
    return grad


class TvMeansFn(torch.autograd.Function):
    """(B, 2) per-lane (mean |dx|, mean |dy|) of an NHWC batch."""

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
        return kx * _dx_part(y) + ky * _dy_part(y)


def lane_total_variation(y: torch.Tensor) -> torch.Tensor:
    """y: NHWC float32 batch of B lanes. Returns the (B,) squared-mean TV
    of each image on its own."""
    means = TvMeansFn.apply(y)
    return means[:, 0] * means[:, 0] + means[:, 1] * means[:, 1]


def total_variation(y: torch.Tensor) -> torch.Tensor:
    """y: NHWC float32 batch. Returns scalar (mean|dx|)^2 + (mean|dy|)^2,
    the means taken over the whole batch."""
    mx, my = TvMeansFn.apply(y).mean(dim=0)
    return mx * mx + my * my
