"""A batch's lanes over the jobs axis of a mesh (parallel/mesh.py).

A batch on a mesh whose jobs axis is A holds A shards: contiguous runs of
its lanes, each a one-card ``BatchedTransferJob`` on its jobs row's device
with its own targets and captured graph. This module holds what the
sharded batch is made of:

- ``run_on_shards``: each shard's work in a host thread of its own. One
  worker thread per (device, slot), kept for the process, calls
  ``torch.cuda.set_device`` once; an L-BFGS step reads its losses on the
  host, so one thread driving every card would make each card wait for
  the others' reads. The caller waits for every shard and raises the
  first shard's error: a batch does not finish on the remaining cards.
  A caller that holds ``config.precision_gate`` lends it to the workers.
- ``Lanes``: a (B, ...) lane-stacked tensor as its pieces in lane order,
  each on its own device. ``take`` copies rows on their own devices,
  ``gather_lanes`` brings rows of any pieces to one device (a lane that
  moves to another card at a convergence shrink or a live rebuild).
- ``ShardedOpt``: the optimizers of the shards; ``leaves()`` gives the
  state of the whole batch in lane order on the host, the form of an
  unsharded batch's state (so a checkpoint is the same file).
"""

from __future__ import annotations

import contextlib
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from ..config import held_precision, join_precision_gate

_workers: Dict[Tuple[str, int], ThreadPoolExecutor] = {}
_workers_lock = threading.Lock()


def _worker(device: torch.device, slot: int) -> ThreadPoolExecutor:
    """The thread of the slot-th shard on `device` (a mesh may name one
    device twice)."""
    key = (str(device), slot)
    with _workers_lock:
        pool = _workers.get(key)
        if pool is None:
            init = ((lambda: torch.cuda.set_device(device))
                    if device.type == "cuda" else None)
            pool = _workers[key] = ThreadPoolExecutor(
                1, thread_name_prefix=f"astt-shard-{device}-{slot}",
                initializer=init)
        return pool


def run_on_shards(devices: Sequence[torch.device],
                  fns: Sequence[Callable[[], object]]) -> list:
    """[fns[i]() for every shard i], each run in the worker thread of
    devices[i], all at once. Waits for every shard, then raises the first
    error any of them raised. Workers hold the caller's precision gate."""
    precision = held_precision()

    def call(fn):
        with (join_precision_gate(precision) if precision is not None
              else contextlib.nullcontext()):
            return fn()

    seen: Dict[str, int] = {}
    futures = []
    for dev, fn in zip(devices, fns):
        slot = seen.get(str(dev), 0)
        seen[str(dev)] = slot + 1
        futures.append(_worker(dev, slot).submit(call, fn))
    results, error = [], None
    for fut in futures:
        try:
            results.append(fut.result())
        except BaseException as e:  # noqa: BLE001 — raised below
            if error is None:
                error = e
    if error is not None:
        raise error
    return results


def shard_bounds(sizes: Sequence[int]) -> List[Tuple[int, int]]:
    """[(first lane, end lane)] of shards of the given sizes."""
    out, a = [], 0
    for n in sizes:
        out.append((a, a + n))
        a += n
    return out


class Lanes:
    """A lane-stacked tensor as its pieces, in lane order, each on its own
    device: a sharded batch's images, losses and state leaves."""

    def __init__(self, parts: Sequence[torch.Tensor]):
        self.parts = list(parts)

    @property
    def shape(self) -> tuple:
        return ((sum(p.shape[0] for p in self.parts),)
                + tuple(self.parts[0].shape[1:]))

    def clone(self) -> "Lanes":
        return Lanes([p.clone() for p in self.parts])

    def cpu(self) -> torch.Tensor:
        """The whole tensor on the host."""
        return torch.cat([p.cpu() for p in self.parts])

    def __getitem__(self, lane: int) -> torch.Tensor:
        for p in self.parts:
            if lane < p.shape[0]:
                return p[lane]
            lane -= p.shape[0]
        raise IndexError("lane out of range")

    def _runs(self, rows: Sequence[int]):
        """(piece, [local rows]) for each maximal run of `rows` that lies
        in one piece."""
        starts = [a for a, _b in shard_bounds([p.shape[0]
                                               for p in self.parts])]
        out: List[Tuple[int, List[int]]] = []
        for r in rows:
            i = max(k for k, a in enumerate(starts) if a <= r)
            if out and out[-1][0] == i:
                out[-1][1].append(r - starts[i])
            else:
                out.append((i, [r - starts[i]]))
        return out

    def take(self, rows: Sequence[int]) -> "Lanes":
        """Rows `rows`, in that order, each copied on its own device."""
        return Lanes([self.parts[i].index_select(
            0, torch.as_tensor(local, dtype=torch.long,
                               device=self.parts[i].device))
            for i, local in self._runs(rows)])

    def with_head(self, rows: "Lanes") -> "Lanes":
        """A copy whose first rows are `rows`, each moved to the device of
        the piece it lands in (the state transplant of a live rebuild)."""
        n = rows.shape[0]
        out = []
        for (a, b), part in zip(shard_bounds([p.shape[0]
                                              for p in self.parts]),
                                self.parts):
            part = part.clone()
            if a < n:
                part[:min(b, n) - a] = gather_lanes(
                    rows.parts, range(a, min(b, n)), part.device)
            out.append(part)
        return Lanes(out)


def gather_lanes(parts: Sequence[torch.Tensor], rows: Sequence[int],
                 device) -> torch.Tensor:
    """Rows `rows` of the concatenation of `parts` (in lane order), copied
    to `device`."""
    pieces = [p.to(device) for p in Lanes(parts).take(list(rows)).parts]
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces)


def split_rows(leaf: torch.Tensor, bounds) -> List[torch.Tensor]:
    """A host leaf over every lane cut into the shards' rows; a 0-d leaf
    (a count the lanes share) goes to every shard whole."""
    if leaf.dim() == 0:
        return [leaf] * len(bounds)
    return [leaf[a:b] for a, b in bounds]


class ShardedOpt:
    """The optimizers of a sharded batch, one per shard, in lane order;
    lanes[i] is shard i's lane count."""

    def __init__(self, opts: Sequence, lanes: Sequence[int]):
        self.opts = list(opts)
        self.lanes = list(lanes)

    def shard_leaves(self) -> Dict[str, object]:
        """The named leaves of the whole batch: each a Lanes of the shards'
        leaves, but a 0-d counter that every shard holds at one value
        (the lanes stepped together), which stays one 0-d tensor."""
        per = [opt.leaves() for opt in self.opts]
        out: Dict[str, object] = {}
        for name in per[0]:
            parts = [p[name] for p in per]
            if all(t.dim() == 0 for t in parts) and all(
                    bool(t == parts[0]) for t in parts):
                out[name] = parts[0]
            else:
                out[name] = Lanes([t.expand(n) if t.dim() == 0 else t
                                   for t, n in zip(parts, self.lanes)])
        return out

    def leaves(self) -> Dict[str, torch.Tensor]:
        """shard_leaves on the host, in lane order: an unsharded batch's
        state."""
        return {name: leaf.cpu() for name, leaf in
                self.shard_leaves().items()}
