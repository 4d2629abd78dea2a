"""Total-variation op: thin dispatch onto kernels/tv.py.

The reference's non-standard squared TV (reference math_utils.py:37-41):
(mean |dx|)^2 + (mean |dy|)^2 of an NHWC image. ``lane_total_variation``
takes it per image of a batch, (B,) values, as the JAX package's
``tv_pallas`` under ``jax.vmap`` (each lane a batch of one); it is the
form the engine runs, through LaneTvFn, the counterpart of ``_tv_impl``:
one forward kernel launch (means and squares) and one backward kernel
launch for every lane on a CUDA tensor, the plain versions on the CPU.
``space_total_variation`` is LaneTvFn over an image held as its row
blocks on the devices of a space row (parallel/space.py), through
SpaceTvFn: one seam launch of each kernel per block. ``total_variation``
takes it over the whole batch, as the JAX function
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
from .blocks import on_block, shard_sum


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


class SpaceTvFn(torch.autograd.Function):
    """LaneTvFn of an NHWC batch held as its row blocks, block k on the
    space row's k-th device (parallel/space.py). Forward: each block's
    partial means from the forward kernel with the image's height and the
    next block's first row as its halo (copied to the block's device);
    the means summed on the first device in shard order, then squared.
    Backward: the backward kernel per block with the image's means (copied
    to each device), and each halo row's gradient added to the first row
    of the block it came from."""

    @staticmethod
    def forward(ctx, *blocks: torch.Tensor) -> torch.Tensor:
        blocks = [y.contiguous() for y in blocks]
        h_total = sum(y.shape[1] for y in blocks)
        halo_rows, parts = [], []
        for k, y in enumerate(blocks):
            with on_block(k):
                halo = None
                if k + 1 < len(blocks):  # the next block's first row
                    halo = (blocks[k + 1][:, 0].reshape(y.shape[0], -1)
                            .to(y.device).contiguous())
                    halo_rows.append(halo)
                parts.append(ktv.tv(y, h_total, halo)[1])
        means = shard_sum(parts)
        ctx.h_total = h_total
        ctx.save_for_backward(means, *blocks, *halo_rows)
        return means[:, 0] * means[:, 0] + means[:, 1] * means[:, 1]

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        means, *rest = ctx.saved_tensors
        n = (len(rest) + 1) // 2
        blocks, halo_rows = rest[:n], list(rest[n:]) + [None]
        grads, seams = [], []
        for y, halo in zip(blocks, halo_rows):
            out = ktv.tv_bwd(y, g.to(y.device), means.to(y.device),
                             ctx.h_total, halo)
            grads.append(out if halo is None else out[0])
            seams.append(None if halo is None else out[1])
        # each halo row's gradient joins the first row it was copied from
        for k, seam in enumerate(seams[:-1]):
            first = grads[k + 1][:, 0]
            first += seam.reshape(first.shape).to(first.device)
        return tuple(grads)


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


def space_total_variation(blocks) -> torch.Tensor:
    """lane_total_variation of an image batch held as its row blocks
    (parallel/space.py): the (B,) TV on the first block's device."""
    return SpaceTvFn.apply(*blocks)


def total_variation(y: torch.Tensor) -> torch.Tensor:
    """y: NHWC float32 batch. Returns scalar (mean|dx|)^2 + (mean|dy|)^2,
    the means taken over the whole batch."""
    mx, my = TvMeansFn.apply(y).mean(dim=0)
    return mx * mx + my * my
