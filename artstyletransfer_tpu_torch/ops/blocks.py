"""Row blocks of one image over the devices of a space row: the
primitives the block forms of the ops and of VGG19 share
(parallel/space.py holds the layout and the gate).

- a 3x3 convolution or the bicubic downscale takes one row from each
  neighbour (``halos``): a slice of the neighbour's block copied to this
  block's device. Each is one autograd node over the row's blocks whose
  backward adds each halo row's gradient to the row it came from, in
  block order, and a block that several nodes use reaches each through
  its own view (``fan_out``): autograd's per-device threads run the
  per-block work of the backward at once, and would otherwise add a
  block's gradients in the order they arrive, which varies;
- every sum over the pixels (a partial Gram, the content and TV sums, an
  L-BFGS dot product) is formed per block on its own device and summed on
  the row's first device in shard order (``shard_sum``), so the result
  does not depend on which card finishes first.

A row may name one device S times (the CPU tests, and a rehearsal on one
card): every halo and partial sum still runs, as copies on one device.
``current_block`` tells which block the forward is building (the memory
report attributes saved activations by it).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Sequence

import torch

_local = threading.local()


@contextlib.contextmanager
def on_block(k: int):
    """Marks the forward work of block k (see current_block)."""
    prev = getattr(_local, "block", 0)
    _local.block = k
    try:
        yield
    finally:
        _local.block = prev


def current_block() -> int:
    """The block whose forward the calling thread is building (0 outside
    on_block: the row's first device, where the partial sums meet)."""
    return getattr(_local, "block", 0)


def shard_sum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """sum(parts) on the first part's device, added in shard order."""
    dev = parts[0].device
    out = parts[0]
    for p in parts[1:]:
        out = out + p.to(dev)
    return out


def halos(blocks: Sequence[torch.Tensor], dim: int):
    """[(up, dn)] per block: the last row (along dim) of the block above
    and the first row of the block below, each copied to this block's
    device; None at the image's top and bottom."""
    out = []
    n = len(blocks)
    for k, b in enumerate(blocks):
        up = (blocks[k - 1].narrow(dim, blocks[k - 1].shape[dim] - 1, 1)
              .to(b.device) if k > 0 else None)
        dn = (blocks[k + 1].narrow(dim, 0, 1).to(b.device)
              if k < n - 1 else None)
        out.append((up, dn))
    return out


class _Fan(torch.autograd.Function):
    """apply(copies, *blocks): each block `copies` times, as views, each
    use its own output; the backward adds each block's gradients in the
    order of the copies."""

    @staticmethod
    def forward(ctx, copies: int, *blocks):
        ctx.set_materialize_grads(False)
        ctx.n = len(blocks)
        return tuple(b.view_as(b) for _ in range(copies) for b in blocks)

    @staticmethod
    def backward(ctx, *grads):
        out = []
        for k in range(ctx.n):
            total = None
            for g in grads[k::ctx.n]:
                if g is not None:
                    total = g if total is None else total + g
            out.append(total)
        return (None, *out)


def fan_out(blocks: Sequence[torch.Tensor], copies: int) -> list:
    """`copies` lists of the row blocks (views), one for each use: a
    block used by several nodes of a space row's graph gets each use's
    gradient in that node, and they are added in the order of the uses,
    whichever device's autograd thread delivers them first."""
    flat = _Fan.apply(copies, *blocks)
    n = len(blocks)
    return [list(flat[c * n:(c + 1) * n]) for c in range(copies)]
