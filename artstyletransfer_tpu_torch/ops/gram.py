"""Gram matrix op: thin dispatch onto kernels/gram.py.

gram_matrix(x) of an NHWC feature map is the (b, c, c) float32 batch of
F^T F / (c*h*w) with F = x[i].reshape(h*w, c) (reference math_utils.py:
26-34), one Gram per batch element (lane), from one kernel launch. Its
autograd backward is the Gram-backward kernel with g_sym = s (G_bar +
G_bar^T), as the JAX package's ``_gram_vjp_bwd``, again one launch for
every lane. A CUDA tensor runs the kernels, a CPU tensor their plain
versions.
"""

from __future__ import annotations

import torch

from ..kernels import gram as kgram
from .blocks import on_block, shard_sum


def features(x: torch.Tensor) -> torch.Tensor:
    """An NHWC map as the (b, h*w, c) stack of its lanes' row-major feature
    matrices (a view when the map is NHWC-contiguous, as the VGG taps
    are)."""
    b, h, w, c = x.shape
    return x.reshape(b, h * w, c).contiguous()


class GramFn(torch.autograd.Function):
    """(b, h, w, c) -> (b, c, c) float32, s * F^T F per batch element."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, scale: float) -> torch.Tensor:
        ctx.save_for_backward(x)
        ctx.scale = scale
        return kgram.gram(features(x), scale)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (x,) = ctx.saved_tensors
        g_sym = ((g + g.transpose(-1, -2)) * ctx.scale).float().contiguous()
        dx = kgram.gram_bwd(features(x), g_sym)
        return dx.reshape(x.shape), None


def gram_matrix(x: torch.Tensor, should_normalize: bool = True) -> torch.Tensor:
    """Batched Gram matrix of an NHWC feature map -> (b, c, c) float32."""
    _, h, w, c = x.shape
    scale = 1.0 / (c * h * w) if should_normalize else 1.0
    return GramFn.apply(x, scale)


def space_gram_matrix(blocks) -> torch.Tensor:
    """gram_matrix of an NHWC map held as its row blocks on the devices of
    a space row (parallel/space.py): each block's partial Gram with the
    whole map's scale 1 / (c h w), summed on the first block's device in
    shard order; its backward is each block's own Gram backward."""
    _, _, w, c = blocks[0].shape
    scale = 1.0 / (c * sum(b.shape[1] for b in blocks) * w)
    parts = []
    for k, f in enumerate(blocks):
        with on_block(k):
            parts.append(GramFn.apply(f, scale))
    return shard_sum(parts)
