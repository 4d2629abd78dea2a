"""Total-variation op: thin dispatch onto kernels/tv.py.

The reference's non-standard squared TV (reference math_utils.py:37-41):
(mean |dx|)^2 + (mean |dy|)^2 over an NHWC batch. The forward sums come
from the TV kernel on a CUDA tensor and its plain version on the CPU. The
backward is plain PyTorch, as it is XLA in the JAX package
(``_tv_vjp_bwd``): sign(0) = 0, like autodiff of |.|.
"""

from __future__ import annotations

import torch

from ..kernels import tv as ktv


def _dx_part(y: torch.Tensor) -> torch.Tensor:
    b, h, w, c = y.shape
    sx = torch.sign(y[:, :, :-1, :] - y[:, :, 1:, :]) / (b * h * (w - 1) * c)
    grad = torch.zeros_like(y)
    grad[:, :, :-1, :] += sx
    grad[:, :, 1:, :] -= sx
    return grad


def _dy_part(y: torch.Tensor) -> torch.Tensor:
    b, h, w, c = y.shape
    sy = torch.sign(y[:, :-1, :, :] - y[:, 1:, :, :]) / (b * (h - 1) * w * c)
    grad = torch.zeros_like(y)
    grad[:, :-1, :, :] += sy
    grad[:, 1:, :, :] -= sy
    return grad


class TvFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y: torch.Tensor) -> torch.Tensor:
        b, h, w, c = y.shape
        sx, sy = ktv.tv_sums(y.contiguous())
        mean_x = sx / (b * h * (w - 1) * c)
        mean_y = sy / (b * (h - 1) * w * c)
        ctx.save_for_backward(y, mean_x, mean_y)
        return mean_x * mean_x + mean_y * mean_y

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        y, mean_x, mean_y = ctx.saved_tensors
        return (g * (2.0 * mean_x) * _dx_part(y)
                + g * (2.0 * mean_y) * _dy_part(y))


def total_variation(y: torch.Tensor) -> torch.Tensor:
    """y: NHWC float32 batch. Returns scalar (mean|dx|)^2 + (mean|dy|)^2."""
    return TvFn.apply(y)
