"""One job's pixels over the cards of a space row (parallel/mesh.py).

The port of the JAX package's 'space' axis: there GSPMD shards each
job's image along H over the space axis and inserts the collectives.
Here one host thread drives the S devices of a space row, and the loss
of a lane is one autograd graph that spans them:

- block k of a lane is rows [k h/S, (k+1) h/S) of each pyramid level,
  on the row's k-th device. The NHWC pixels of those rows are contiguous
  in the flat image vector, so the image, its gradient, Adam's moments
  and every L-BFGS s/y history row are S contiguous pieces of it
  (``SpaceLanes``);
- a 3x3 convolution or the bicubic downscale takes one row from each
  neighbour, and every sum over the pixels is formed per block and
  summed on the row's first device in shard order (ops/blocks.py).

Where sharding engages (``space_gate``): the JAX package's
``constrained_space_ok`` (the lowest level's shortest side at least
32 S) and every level's H a multiple of 16 S, so that each block starts
on an even row and has an even height at each of the four pools down to
relu5_1. Elsewhere a space row runs its lanes unsharded on its first
device, the same loss the JAX package computes on its unconstrained path.

A mesh may name one device S times (the CPU tests, and a rehearsal on one
card): every halo and partial sum still runs, as copies on one device.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch

from ..ops.blocks import shard_sum
from .mesh import Mesh

# the JAX package's MIN_LOWEST_LEVEL_PER_SHARD (parallel/batch.py)
MIN_LOWEST_LEVEL_PER_SHARD = 32
# rows per block must stay whole through the four 2x2 pools to relu5_1
POOL_ALIGN = 16


def constrained_space_ok(level_shapes, n_space: int) -> bool:
    """The JAX package's gate for its constrained space-sharded graph: the
    LOWEST pyramid level's shortest side is at least 32 * n_space."""
    lowest = level_shapes[-1]
    return (n_space > 1
            and min(lowest[1], lowest[2])
            >= MIN_LOWEST_LEVEL_PER_SHARD * n_space)


def space_gate(level_shapes, n_space: int) -> Tuple[bool, str]:
    """(whether one job's rows split over n_space devices at these (1, h,
    w, 3) level shapes, the reason when they do not): constrained_space_ok
    and every level's h a multiple of 16 * n_space."""
    if n_space < 2:
        return False, "a space axis of 1"
    if not constrained_space_ok(level_shapes, n_space):
        lowest = level_shapes[-1]
        return False, (f"the lowest level {lowest[1]}x{lowest[2]} is below "
                       f"{MIN_LOWEST_LEVEL_PER_SHARD} x {n_space} px")
    for shape in level_shapes:
        if shape[1] % (POOL_ALIGN * n_space):
            return False, (f"a level's height {shape[1]} is not a multiple "
                           f"of {POOL_ALIGN} x {n_space} (whole rows at "
                           f"every pool)")
    return True, ""


def block_sizes(total: int, n_space: int) -> List[int]:
    """Equal pieces of `total` (which n_space divides)."""
    if total % n_space:
        raise ValueError(f"{total} does not split over {n_space} blocks")
    return [total // n_space] * n_space


def _arg(v, k: int, dev):
    """v as block k's operand: a SpaceLanes' block, a tensor moved to
    block k's device, or a Python number as it is."""
    if isinstance(v, SpaceLanes):
        return v.blocks[k]
    if isinstance(v, torch.Tensor):
        return v.to(dev)
    return v


class SpaceLanes:
    """A tensor whose last axis (the pixels) is cut into S contiguous
    blocks, block k on the space row's k-th device: a space batch's (B, n)
    images, gradients and moments, its (B, m, n) L-BFGS history and its
    flattened content targets. Elementwise arithmetic runs per block (a
    plain tensor operand, e.g. a (B, 1) step size, is copied to each
    block's device); a reduction over the last axis (sum, amax, dot, the
    history contractions) is formed per block and summed on the first
    device in shard order, and returns a plain tensor there. cpu() gathers
    the blocks in pixel order, the layout of an unsharded batch."""

    def __init__(self, blocks: Sequence[torch.Tensor]):
        self.blocks = list(blocks)

    @classmethod
    def split(cls, t: torch.Tensor, devices: Sequence) -> "SpaceLanes":
        """t's last axis cut into len(devices) equal blocks, block k
        copied to devices[k]."""
        sizes = block_sizes(t.shape[-1], len(devices))
        return cls([piece.to(dev) for piece, dev in
                    zip(torch.split(t, sizes, dim=-1), devices)])

    # ---- layout ----------------------------------------------------------

    @property
    def devices(self) -> List[torch.device]:
        return [b.device for b in self.blocks]

    @property
    def device(self) -> torch.device:
        """The first device: where the row's scalars and sums live."""
        return self.blocks[0].device

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    @property
    def shape(self) -> tuple:
        return (tuple(self.blocks[0].shape[:-1])
                + (sum(b.shape[-1] for b in self.blocks),))

    def dim(self) -> int:
        return self.blocks[0].dim()

    def place(self, leaf):
        """A tensor of this layout's shape cut into blocks on this row's
        devices (a SpaceLanes stays as it is)."""
        if isinstance(leaf, SpaceLanes):
            return leaf
        return SpaceLanes.split(leaf, self.devices)

    def cpu(self) -> torch.Tensor:
        return torch.cat([b.detach().cpu() for b in self.blocks], dim=-1)

    # ---- elementwise -----------------------------------------------------

    def _map(self, fn: Callable) -> "SpaceLanes":
        return SpaceLanes([fn(b) for b in self.blocks])

    def _with(self, other, fn: Callable) -> "SpaceLanes":
        return SpaceLanes([fn(b, _arg(other, k, b.device))
                           for k, b in enumerate(self.blocks)])

    def __add__(self, o):
        return self._with(o, lambda a, b: a + b)

    def __sub__(self, o):
        return self._with(o, lambda a, b: a - b)

    def __mul__(self, o):
        return self._with(o, lambda a, b: a * b)

    def __rmul__(self, o):
        return self._with(o, lambda a, b: b * a)

    def __truediv__(self, o):
        return self._with(o, lambda a, b: a / b)

    def __neg__(self):
        return self._map(lambda a: -a)

    def abs(self):
        return self._map(torch.abs)

    def sqrt(self):
        return self._map(torch.sqrt)

    def float(self):
        return self._map(lambda a: a.float())

    def to(self, dtype: torch.dtype):
        return self._map(lambda a: a.to(dtype))

    def clone(self):
        return self._map(torch.clone)

    def zeros_like(self):
        return self._map(torch.zeros_like)

    def addcmul(self, t, d):
        """self + t * d, per block."""
        return SpaceLanes([b.addcmul(_arg(t, k, b.device),
                                     _arg(d, k, b.device))
                           for k, b in enumerate(self.blocks)])

    # ---- rows ------------------------------------------------------------

    def __getitem__(self, key):
        """Index the leading axes of every block (never the pixels)."""
        return self._map(lambda b: b[key])

    def __setitem__(self, key, value) -> None:
        """Write `value` (a SpaceLanes of this layout) at `key`, an index
        of the leading axes whose tensors are copied to each device."""
        keys = key if isinstance(key, tuple) else (key,)
        for k, b in enumerate(self.blocks):
            b[tuple(_arg(i, k, b.device) for i in keys)] = value.blocks[k]

    def index_select(self, dim: int, idx: torch.Tensor):
        return SpaceLanes([b.index_select(dim, idx.to(b.device))
                           for b in self.blocks])

    @staticmethod
    def stack(rows: Sequence["SpaceLanes"]) -> "SpaceLanes":
        """torch.stack of rows, block by block."""
        return SpaceLanes([torch.stack([r.blocks[k] for r in rows])
                           for k in range(len(rows[0].blocks))])

    # ---- reductions over the pixels (on the first device) ----------------

    def _last(self, dim: int) -> None:
        if dim not in (-1, self.dim() - 1):
            raise ValueError("a SpaceLanes reduces over its pixel axis only")

    def sum(self, dim: int):
        self._last(dim)
        return shard_sum([b.sum(dim=-1) for b in self.blocks])

    def amax(self, dim: int):
        self._last(dim)
        dev = self.device
        return torch.stack([b.amax(dim=-1).to(dev)
                            for b in self.blocks]).amax(dim=0)

    def dot(self, other: "SpaceLanes"):
        return shard_sum([torch.dot(a, b) for a, b in
                          zip(self.blocks, other.blocks)])

    def rows_dot(self, v: "SpaceLanes", bmm: Callable):
        """(B, k): each row of this (B, k, n) history dotted with the
        lane's (B, n) vector v."""
        return shard_sum([bmm(h, x.unsqueeze(2)).squeeze(2)
                          for h, x in zip(self.blocks, v.blocks)])

    def gram(self, other: "SpaceLanes", bmm: Callable):
        """(B, k, k): this (B, k, n) history times the transpose of
        `other`."""
        return shard_sum([bmm(a, b.transpose(1, 2))
                          for a, b in zip(self.blocks, other.blocks)])

    def combine(self, coef: torch.Tensor, bmm: Callable) -> "SpaceLanes":
        """(B, n): coef (B, k) times this (B, k, n) history, per block."""
        return SpaceLanes([bmm(coef.to(h.device).unsqueeze(1), h).squeeze(1)
                           for h in self.blocks])


def row_mesh(mesh, jobs_row: int) -> Mesh:
    """Jobs row `jobs_row` of a ('jobs', 'space') mesh as a mesh of its
    own, of one jobs row: where a batch's shard, or the one-card batch of
    the memory report, splits its lanes' rows."""
    n = mesh.shape.get("space", 1)
    return Mesh(mesh.devices[jobs_row * n:(jobs_row + 1) * n],
                ("jobs", "space"), (1, n))
