"""Content / style / TV losses for one pyramid level.

Reference parity (reference neural_style_transfer.py:84-112):
- content loss: mean MSE between conv4_2 feature maps
- style loss: mean over style layers of MSE between Gram matrices, taking
  batch element [0] of each Gram
- tv loss: squared-mean TV of the (preprocessed) level image
- level total = content_weight*content + style_weight*style + tv_weight*tv
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..kernels import gram as kgram
from .gram import features, gram_matrix
from .tv import total_variation


class LevelLoss(NamedTuple):
    total: torch.Tensor
    content: torch.Tensor
    style: torch.Tensor
    tv: torch.Tensor


def content_loss(target_content: torch.Tensor,
                 current_content: torch.Tensor) -> torch.Tensor:
    """MSE between content-tap feature maps, accumulated in float32."""
    return torch.mean(torch.square(target_content.float()
                                   - current_content.float()))


def regularization(y: torch.Tensor) -> torch.Tensor:
    """sum((y/128)^10) / numel^10 — present in the reference but unused
    (reference math_utils.py:44-47). Kept for component parity."""
    els = float(np.prod(tuple(y.shape)))
    return torch.sum(torch.pow(y / 128.0, 10)) / (els ** 10)


def style_loss(target_grams: Sequence[torch.Tensor],
               current_grams: Sequence[torch.Tensor]) -> torch.Tensor:
    """Mean over layers of MSE between Gram matrices (batch element 0)."""
    acc = 0.0
    for gt, gh in zip(target_grams, current_grams):
        acc = acc + torch.mean(torch.square(gt[0] - gh[0]))
    return acc / len(target_grams)


class StyleLayerMSE(torch.autograd.Function):
    """mean((gram(f)[0] - gt)^2) with the closed-form backward.

    The port of the JAX package's ``_style_layer_mse_convbwd``
    (ops/losses.py:79-114). Forward: the Gram kernel. Backward: the
    Gram-backward kernel, df = f @ g_sym with
    g_sym = (D + D^T) * 2s / (c^3 h w), D = G - Gt (real target Grams are
    symmetric, making D + D^T = 2D, but that is not assumed). g_sym stays
    float32 (the JAX package rounds it to the tap dtype first). Batch 1
    only, the engine's invariant.
    """

    @staticmethod
    def forward(ctx, f: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
        _, h, w, c = f.shape
        g = kgram.gram(features(f, 0), 1.0 / (c * h * w))
        ctx.save_for_backward(f, g, gt)
        return torch.mean(torch.square(g - gt))

    @staticmethod
    def backward(ctx, s: torch.Tensor):
        f, g, gt = ctx.saved_tensors
        _, h, w, c = f.shape
        d = g - gt
        g_sym = ((d + d.T) * (s * (2.0 / (c * c * c * h * w)))).contiguous()
        df = kgram.gram_bwd(features(f, 0), g_sym)
        return df.reshape(f.shape), None


def level_loss(feats, target_content: torch.Tensor,
               target_grams: Sequence[torch.Tensor], level_img: torch.Tensor,
               content_weight: float, style_weight: float, tv_weight: float,
               content_index: int = 4,
               style_indices: Sequence[int] = (0, 1, 2, 3, 5),
               use_pallas: bool = False,
               fused_style_bwd: bool = True) -> LevelLoss:
    """Weighted loss of one pyramid level given current feature taps.

    fused_style_bwd (default on) takes each style layer's loss through
    StyleLayerMSE (closed-form backward) for batch-1 taps; otherwise the
    Grams go through gram_matrix and autograd, whose backward is the same
    Gram-backward kernel with the Gram's own g_sym.

    use_pallas is kept for parity with the JAX package's signature and
    selects the same branch it does there (it turns the fused path off).
    It does not select the kernels: on a CUDA tensor the Gram, its
    backward and the TV run through the hand-written kernels either way,
    and on a CPU tensor through their plain versions.
    """
    c = content_loss(target_content, feats[content_index])
    if fused_style_bwd and not use_pallas and all(
            feats[i].shape[0] == 1 for i in style_indices):
        acc = 0.0
        for gt, i in zip(target_grams, style_indices):
            acc = acc + StyleLayerMSE.apply(feats[i], gt[0])
        s = acc / len(target_grams)
    else:
        current_grams = [gram_matrix(feats[i]) for i in style_indices]
        s = style_loss(target_grams, current_grams)
    t = total_variation(level_img)
    total = content_weight * c + style_weight * s + tv_weight * t
    return LevelLoss(total=total, content=c, style=s, tv=t)
