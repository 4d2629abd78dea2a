"""Fused SAME 3x3 conv + bias + ReLU op: thin dispatch onto
kernels/conv_relu.py.

conv3x3_relu(x, w, b) is the port of the JAX package's
``conv3x3_relu_pallas`` (ops/pallas_kernels.py:332): NHWC input, HWIO
weights, float32. Its forward is the hand-written kernel on a CUDA tensor
and the plain version on a CPU tensor. Its backward rematerialises the
plain version (F.conv2d + bias + ReLU) and differentiates it with
autograd, as ``_conv_relu_vjp_bwd`` differentiates the XLA twin.

Like the JAX package's block it is not on the engine's path: VGG19 runs
its convolutions through the framework (cuDNN here, XLA there).
"""

from __future__ import annotations

import torch

from ..kernels import conv_relu as kconv


class ConvReluFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x, w, b)
        return kconv.conv_relu(x, w, b)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, w, b = ctx.saved_tensors
        with torch.enable_grad():
            xs, ws, bs = (t.detach().requires_grad_(True) for t in (x, w, b))
            y = kconv.conv_relu_plain(xs, ws, bs)
            return torch.autograd.grad(y, (xs, ws, bs), g)


def conv3x3_relu(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """max(0, conv3x3_SAME(x, w) + b): x (N, H, W, Cin), w (3, 3, Cin,
    Cout), b (Cout,), all float32 -> (N, H, W, Cout) float32."""
    return ConvReluFn.apply(x, w, b)
