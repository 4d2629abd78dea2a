"""Content / style / TV losses for one pyramid level, per lane of a batch.

Reference parity (reference neural_style_transfer.py:84-112), for each
lane (batch element) b:
- content loss: mean MSE between lane b's conv4_2 feature maps
- style loss: mean over style layers of MSE between lane b's Gram matrices
- tv loss: squared-mean TV of lane b's (preprocessed) level image
- level total = content_weight*content + style_weight*style + tv_weight*tv

Every loss is a (B,) tensor: the JAX package runs one job per lane under
``jax.vmap``, where each of these reductions sees a batch of one; here the
lane axis is written out and every reduction stays inside its lane. A
batch of one gives the single job's losses.

``space_level_loss`` is level_loss over an image held as its row blocks
on the devices of a space row (parallel/space.py): each sum over the
pixels is formed per block and the blocks' partials meet on the first
device, where the (B,) losses are.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..kernels import gram as kgram
from .blocks import on_block, shard_sum
from .gram import features, gram_matrix, space_gram_matrix
from .tv import lane_total_variation, space_total_variation


class LevelLoss(NamedTuple):
    total: torch.Tensor
    content: torch.Tensor
    style: torch.Tensor
    tv: torch.Tensor


def _lane_mean(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(t.shape[0], -1).mean(dim=1)


def content_loss(target_content: torch.Tensor,
                 current_content: torch.Tensor) -> torch.Tensor:
    """(B,) MSE between content-tap feature maps, accumulated in float32."""
    return _lane_mean(torch.square(target_content.float()
                                   - current_content.float()))


def regularization(y: torch.Tensor) -> torch.Tensor:
    """(B,) sum((y/128)^10) / numel^10 over each lane — present in the
    reference but unused (reference math_utils.py:44-47). Kept for
    component parity."""
    els = float(np.prod(tuple(y.shape[1:])))
    return torch.pow(y / 128.0, 10).reshape(y.shape[0], -1).sum(dim=1) / (
        els ** 10)


def style_loss(target_grams: Sequence[torch.Tensor],
               current_grams: Sequence[torch.Tensor]) -> torch.Tensor:
    """(B,) mean over layers of the MSE between each lane's (c, c) Grams."""
    acc = 0.0
    for gt, gh in zip(target_grams, current_grams):
        acc = acc + _lane_mean(torch.square(gt - gh))
    return acc / len(target_grams)


class StyleLayerMSE(torch.autograd.Function):
    """(B,) mean((gram(f)[b] - gt[b])^2) with the closed-form backward.

    The port of the JAX package's ``_style_layer_mse_convbwd``
    (ops/losses.py:79-114), with the lane axis written out. Forward: the
    Gram kernel, all lanes in one launch. Backward: the Gram-backward
    kernel, all lanes in one launch, df[b] = f[b] @ g_sym[b] with
    g_sym[b] = (D + D^T) * 2 s[b] / (c^3 h w), D = G[b] - Gt[b] (real
    target Grams are symmetric, making D + D^T = 2D, but that is not
    assumed). g_sym stays float32 (the JAX package rounds it to the tap
    dtype first).
    """

    @staticmethod
    def forward(ctx, f: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
        _, h, w, c = f.shape
        g = kgram.gram(features(f), 1.0 / (c * h * w))
        ctx.save_for_backward(f, g, gt)
        return _lane_mean(torch.square(g - gt))

    @staticmethod
    def backward(ctx, s: torch.Tensor):
        f, g, gt = ctx.saved_tensors
        _, h, w, c = f.shape
        d = g - gt
        scale = s.view(-1, 1, 1) * (2.0 / (c * c * c * h * w))
        g_sym = ((d + d.transpose(-1, -2)) * scale).contiguous()
        df = kgram.gram_bwd(features(f), g_sym)
        return df.reshape(f.shape), None


def level_loss(feats, target_content: torch.Tensor,
               target_grams: Sequence[torch.Tensor], level_img: torch.Tensor,
               content_weight: float, style_weight: float, tv_weight: float,
               content_index: int = 4,
               style_indices: Sequence[int] = (0, 1, 2, 3, 5),
               use_pallas: bool = False,
               fused_style_bwd: bool = True) -> LevelLoss:
    """Weighted (B,) losses of one pyramid level given current feature taps
    of B lanes and each lane's targets ((B, ...) content tap, (B, c, c)
    Grams).

    fused_style_bwd (default on) takes each style layer's loss through
    StyleLayerMSE (closed-form backward); otherwise the Grams go through
    gram_matrix and autograd, whose backward is the same Gram-backward
    kernel with the Gram's own g_sym.

    use_pallas is kept for parity with the JAX package's signature and
    selects the same branch it does there (it turns the fused path off).
    It does not select the kernels: on a CUDA tensor the Gram, its
    backward and the TV run through the hand-written kernels either way,
    and on a CPU tensor through their plain versions.
    """
    c = content_loss(target_content, feats[content_index])
    if fused_style_bwd and not use_pallas:
        acc = 0.0
        for gt, i in zip(target_grams, style_indices):
            acc = acc + StyleLayerMSE.apply(feats[i], gt)
        s = acc / len(target_grams)
    else:
        current_grams = [gram_matrix(feats[i]) for i in style_indices]
        s = style_loss(target_grams, current_grams)
    t = lane_total_variation(level_img)
    total = content_weight * c + style_weight * s + tv_weight * t
    return LevelLoss(total=total, content=c, style=s, tv=t)


class SpaceStyleLayerMSE(torch.autograd.Function):
    """StyleLayerMSE of a tap held as its row blocks (parallel/space.py):
    apply(gt, *blocks). Forward: each block's partial Gram from the Gram
    kernel with the whole tap's scale 1 / (c h w) (h the sum of the
    blocks' rows), summed on the first device in shard order, and the
    (B,) MSE against gt there. Backward: g_sym = (D + D^T) 2 s / (c^3 h
    w) once, on the first device, copied to each block's, and each
    block's df = F g_sym from the Gram-backward kernel."""

    @staticmethod
    def forward(ctx, gt: torch.Tensor, *fs: torch.Tensor) -> torch.Tensor:
        _, _, w, c = fs[0].shape
        h = sum(f.shape[1] for f in fs)
        parts = []
        for k, f in enumerate(fs):
            with on_block(k):
                parts.append(kgram.gram(features(f), 1.0 / (c * h * w)))
        g = shard_sum(parts)
        ctx.h = h
        ctx.save_for_backward(g, gt, *fs)
        return _lane_mean(torch.square(g - gt))

    @staticmethod
    def backward(ctx, s: torch.Tensor):
        g, gt, *fs = ctx.saved_tensors
        _, _, w, c = fs[0].shape
        d = g - gt
        scale = s.view(-1, 1, 1) * (2.0 / (c * c * c * ctx.h * w))
        g_sym = ((d + d.transpose(-1, -2)) * scale).contiguous()
        return (None, *(kgram.gram_bwd(features(f), g_sym.to(f.device))
                        .reshape(f.shape) for f in fs))


def space_content_loss(target_blocks: Sequence[torch.Tensor],
                       current_blocks: Sequence[torch.Tensor]) -> torch.Tensor:
    """content_loss of a tap held as its row blocks: each block's sum of
    squares, summed on the first device in shard order, over the whole
    tap's element count."""
    count = 0
    parts = []
    for k, (t, f) in enumerate(zip(target_blocks, current_blocks)):
        with on_block(k):
            sq = torch.square(t.float() - f.float())
            parts.append(sq.reshape(sq.shape[0], -1).sum(dim=1))
            count += sq[0].numel()
    return shard_sum(parts) / count


def space_level_loss(feats, target_content, target_grams: Sequence[torch.Tensor],
                     level_blocks, content_weight: float, style_weight: float,
                     tv_weight: float, content_index: int = 4,
                     style_indices: Sequence[int] = (0, 1, 2, 3, 5),
                     use_pallas: bool = False,
                     fused_style_bwd: bool = True) -> LevelLoss:
    """level_loss of one level held as its row blocks (parallel/space.py):
    feats one Vgg19Features per block, target_content the flattened
    content tap as a SpaceLanes of the same rows, target_grams the (B, c,
    c) Grams on the first device, level_blocks the level image's blocks.
    The (B,) losses are on the first device."""
    taps = [f[content_index] for f in feats]
    t_blocks = [t.reshape(f.shape) for t, f in
                zip(target_content.blocks, taps)]
    c = space_content_loss(t_blocks, taps)
    if fused_style_bwd and not use_pallas:
        acc = 0.0
        for gt, i in zip(target_grams, style_indices):
            acc = acc + SpaceStyleLayerMSE.apply(gt, *(f[i] for f in feats))
        s = acc / len(target_grams)
    else:
        current_grams = [space_gram_matrix([f[i] for f in feats])
                         for i in style_indices]
        s = style_loss(target_grams, current_grams)
    t = space_total_variation(level_blocks)
    total = content_weight * c + style_weight * s + tv_weight * t
    return LevelLoss(total=total, content=c, style=s, tv=t)
