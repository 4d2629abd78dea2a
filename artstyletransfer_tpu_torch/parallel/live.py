"""Live batching: jobs join and leave an in-flight batch at chunk
boundaries.

The port of the JAX package's ``parallel/live.py``. The round-based
online executor (runtime/online.py) bounds a newcomer's wait by the whole
in-flight round. Here one ``LiveBatchRunner`` per shape bucket owns an
in-flight batch of lanes on the card whose composition changes at chunk
boundaries:

- JOIN: pending jobs enter by rebuilding the batch at the next power of
  two (the sizes the serving warmup captures) and transplanting the
  surviving lanes' state rows, so a newcomer waits about one chunk.
- LEAVE: a lane that finished its budget (or latched a stop_tol
  convergence) freezes its result and is dropped at the next boundary.
- PER-LANE STEPS: the chunk takes a (B,) vector of start steps
  (``BatchedTransferJob.chunk_steps``), so a lane that joined late still
  runs its own steps 0..k with its own lr schedule and Adam bias
  correction. With a uniform vector the chunk is ``run()``'s bit for bit.

A live chunk replays the same captured evaluation of (bucket, lanes) as
``run()`` (engine/graphs.py); the optimizer's update stays eager, per
lane. Rebuilding releases the old batch before the new one is built.

On a mesh (parallel/mesh.py) the batch is a sharded one (parallel/
batch.py): its capacity is the one-card cap times the jobs axis, a
rebuild is made on the mesh, and the survivors' rows are transplanted
across cards, each to the shard its new lane falls in.

Divergences from the JAX package (deliberate; ROADMAP Queue 3): a
boundary whose joins all overflowed the capacity and where no lane left
does not rebuild; the last chunk is clamped so that no lane runs past
iters_num.
"""

from __future__ import annotations

import threading
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..engine.init_pipeline import build_init_image
from ..utils.image import unprepare_img
from .batch import _gather_rows, lane_leaves, resolve_group_cap
from .mesh import check_mesh, jobs_axis, placement
from .shards import Lanes

# NOTE: BatchedTransferJob is looked up through its module at call time
# (not imported at module load) so test spies patching
# parallel.batch.BatchedTransferJob see the live path too.


def _scatter_head(dst: Dict[str, torch.Tensor],
                  src: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """dst's leaves with rows [0:n] overwritten by src's n rows, in place
    (the state transplant of a rebuild), but for a counter the lanes
    shared (an expanded 0-d leaf), which is copied first. A sharded
    batch's Lanes take each row on the card of the shard it lands in."""
    out = {}
    for name, leaf in dst.items():
        rows = src[name]
        if isinstance(leaf, Lanes):
            out[name] = leaf.with_head(rows)
            continue
        if leaf.stride(0) == 0:
            leaf = leaf.clone()
        leaf[:rows.shape[0]] = rows.to(leaf.device)
        out[name] = leaf
    return out


class StepReport(NamedTuple):
    """What one chunk produced, for the executor to report."""

    progress: List[tuple]          # (tid, percent, image|None, loss)
    finished: Dict[str, tuple]     # tid -> (final image, loss)
    joined: List[str]              # tids that entered at this boundary
    batch: int                     # dispatched (padded) batch size


class LiveBatchRunner:
    """One shape bucket's in-flight batch with boundary joins and leaves.

    Thread contract: submit() may be called from any thread (the
    executor's event loop); step() must be called from one worker thread
    at a time. Pending submissions are drained at the next boundary.
    Runs on CUDA unless device='cpu' is passed; raises when CUDA is
    unavailable and the CPU was not asked for. params: repo-format numpy
    weights, or None for cfg.seed's (shared with every job of that
    source, so live batches replay the warmed graphs). mesh: the batch is
    sharded over its jobs axis (parallel/mesh.py).
    """

    def __init__(self, cfg: Config, params=None, mesh=None,
                 max_batch: Optional[int] = 8,
                 stream_images: bool = True,
                 chunk: Optional[int] = None, device=None):
        check_mesh(mesh)
        self.cfg = cfg
        self.mesh = mesh
        self.device = placement(mesh, device)
        self.params = params
        self.max_batch = max_batch
        self.stream_images = stream_images
        self.chunk = max(1, chunk or cfg.stream_every)
        self.iters = cfg.iters_num
        self._lock = threading.Lock()
        self._pending: List[Tuple[str, np.ndarray, np.ndarray]] = []
        # tid -> (content, style, init) of every task held outside
        # _pending: the batch's live lanes and the joins entering it
        self._specs: Dict[str, tuple] = {}
        self._arrivals = 0                   # seeds the per-job init noise
        self._bj = None                      # the BatchedTransferJob
        self._x: Optional[torch.Tensor] = None
        self._opt = None
        self._lane_tid: List[Optional[str]] = []
        self._lane_steps: Optional[np.ndarray] = None
        self._exited: set = set()            # lanes to drop at the boundary
        self._f_prev: Dict[str, float] = {}
        self._latched: set = set()

    # -- intake ------------------------------------------------------------

    def submit(self, task_id: str, content: np.ndarray,
               style: np.ndarray) -> None:
        with self._lock:
            self._pending.append((task_id, content, style))

    @property
    def active(self) -> bool:
        with self._lock:
            if self._pending:
                return True
        return self._bj is not None

    @property
    def live_tids(self) -> List[str]:
        return [t for t in self._lane_tid if t is not None]

    @property
    def all_tids(self) -> List[str]:
        """Live and queued-for-join task ids (what a progress table must
        consider alive)."""
        with self._lock:
            pending = [t for t, _c, _s in self._pending]
        return self.live_tids + pending

    @property
    def lanes_reserved(self) -> int:
        """Padded lanes this runner's batch occupies (or will occupy at its
        next boundary, once queued joins enter): the unit of the
        executor's global lane budget. Every resident lane (padding
        replicas included) carries full optimizer state."""
        with self._lock:
            pend = len(self._pending)
        live = len([ln for ln, t in enumerate(self._lane_tid)
                    if t is not None and ln not in self._exited])
        n = live + pend
        want = (1 << (n - 1).bit_length()) if n else 0
        cur = len(self._lane_tid) if self._bj is not None else 0
        return max(cur, want)

    # -- boundary maintenance ----------------------------------------------

    def _capacity(self, content_shape) -> int:
        return resolve_group_cap(self.cfg, content_shape,
                                 jobs_axis(self.mesh), "batched",
                                 self.max_batch)

    def _live_lanes(self) -> List[int]:
        return [lane for lane, tid in enumerate(self._lane_tid)
                if tid is not None and lane not in self._exited]

    def _release(self) -> None:
        self._bj = None
        self._x = self._opt = None
        self._lane_tid, self._lane_steps = [], None
        self._exited = set()

    def _rebuild(self, joins) -> List[str]:
        """Re-form the batch: surviving lanes first, then `joins`, padded
        to the next power of two; transplant the survivors' state rows."""
        survivors = self._live_lanes()
        live_tids = [self._lane_tid[lane] for lane in survivors]
        for tid, content, style in joins:  # held from here on
            self._specs[tid] = (content, style, None)
        for tid, content, style in joins:
            rng = np.random.default_rng(self.cfg.seed + self._arrivals)
            self._arrivals += 1
            init_img, _ = build_init_image(self.cfg.init_method, content,
                                           style, self.cfg, rng=rng)
            self._specs[tid] = (content, style, init_img)
        new_tids = [tid for tid, _c, _s in joins]
        tids = live_tids + new_tids
        if not tids:
            self._release()
            return []
        n = len(tids)
        pad_to = 1 << (n - 1).bit_length()

        old_state = None
        if survivors and self._bj is not None:
            # copy the surviving rows out BEFORE the old buffers go away
            old_state = _gather_rows(
                dict(lane_leaves(self._opt, len(self._lane_tid)),
                     x=self._x), survivors)
        old_steps = ([int(self._lane_steps[lane]) for lane in survivors]
                     if self._lane_steps is not None else [])
        # release the whole old batch now (the gather holds the survivors'
        # rows): building the new batch and its L-BFGS init evaluation
        # would otherwise hold both batches' state on the card at once
        self._release()

        from . import batch as batch_mod

        bj = batch_mod.BatchedTransferJob(
            [self._specs[t][0] for t in tids],
            [self._specs[t][1] for t in tids], self.cfg, params=self.params,
            init_overrides=[self._specs[t][2] for t in tids],
            pad_batch_to=pad_to, mesh=self.mesh, device=self.device)
        x = bj._x0.clone()
        opt = bj.init_opt(x)
        if old_state is not None:
            # survivors keep their exact trajectory
            merged = _scatter_head(dict(lane_leaves(opt, bj.batch), x=x),
                                   old_state)
            x = merged.pop("x")
            opt = bj.init_opt(x, merged)
        self._bj, self._x, self._opt = bj, x, opt
        self._lane_tid = tids + [None] * (bj.batch - n)
        self._lane_steps = np.zeros((bj.batch,), dtype=np.int64)
        self._lane_steps[:len(old_steps)] = old_steps
        return new_tids

    # -- one chunk ---------------------------------------------------------

    def step(self) -> StepReport:
        """Boundary maintenance (leave, join, rebuild), then one chunk.

        Returns the chunk's per-task progress and the finished tasks.
        Raises on device failure: the caller owns isolation and retries."""
        with self._lock:
            joins, self._pending = self._pending, []
        if joins:
            # honour the memory/saturation capacity: overflow joins wait
            # for lanes to free up at a later boundary
            room = max(0, self._capacity(joins[0][1].shape)
                       - len(self._live_lanes()))
            if room < len(joins):
                joins, overflow = joins[:room], joins[room:]
                with self._lock:
                    self._pending = overflow + self._pending
        joined: List[str] = []
        # decided after the trim: joins that all overflowed, with no lane
        # leaving, change nothing (the JAX package rebuilds here)
        if self._bj is None or self._exited or joins:
            joined = self._rebuild(joins)
        if self._bj is None:
            return StepReport([], {}, [], 0)

        bj = self._bj
        live = self._live_lanes()
        # the last chunk stops at the smallest remaining budget, so no
        # lane runs past iters_num (the JAX package runs whole chunks)
        k = max(1, min([self.chunk]
                       + [self.iters - int(self._lane_steps[lane])
                          for lane in live]))
        batch_dispatched = len(self._lane_tid)
        self._x, f = bj.chunk_steps(self._x, self._opt, self._lane_steps, k)
        self._lane_steps = self._lane_steps + k

        f_np = f.cpu().numpy()
        top = bj.level_shapes[0]
        rows = None
        if self.stream_images:
            rows = self._x.cpu().numpy().reshape((batch_dispatched,)
                                                 + top[1:])
        check_stop = self.cfg.stop_tol > 0.0
        progress: List[tuple] = []
        finished: Dict[str, tuple] = {}
        for lane, tid in enumerate(self._lane_tid):
            if tid is None:
                continue
            loss = float(f_np[lane])
            steps = int(self._lane_steps[lane])
            if self.cfg.nan_checks and not np.isfinite(loss):
                raise FloatingPointError(
                    f"non-finite loss for live task {tid} at lane step "
                    f"{steps}")
            done_budget = steps >= self.iters
            if check_stop and not done_budget:
                prev = self._f_prev.get(tid)
                if (tid in self._latched
                        or (prev is not None
                            and abs(prev - loss)
                            <= self.cfg.stop_tol * max(1.0, abs(loss)))):
                    self._latched.add(tid)
                    done_budget = True  # converged: leave at this boundary
                self._f_prev[tid] = loss
            if done_budget:
                row = (rows[lane] if rows is not None else
                       self._x[lane].reshape(top[1:]).cpu().numpy())
                img = unprepare_img(row)
                finished[tid] = (img, loss)
                self._exited.add(lane)
                del self._specs[tid]
                self._f_prev.pop(tid, None)
                self._latched.discard(tid)
                progress.append((tid, 100.0, img, loss))
            else:
                progress.append((tid, steps / self.iters * 100.0,
                                 unprepare_img(rows[lane])
                                 if rows is not None else None, loss))
        if not self._live_lanes():
            # every live lane left at this boundary: release the batch now
            # instead of spending a step() on an empty rebuild
            with self._lock:
                drained = not self._pending
            if drained:
                self._rebuild([])
        return StepReport(progress, finished, joined, batch_dispatched)

    def take_all(self) -> List[Tuple[str, np.ndarray, np.ndarray]]:
        """Drop every live and pending task and the batch; returns them as
        (task_id, content, style), for a fresh resubmission or to record
        their failures."""
        with self._lock:
            pending, self._pending = self._pending, []
        tasks = [(tid, content, style)
                 for tid, (content, style, _init) in self._specs.items()]
        self._release()
        self._specs.clear()
        self._f_prev.clear()
        self._latched.clear()
        return tasks + pending

    def fail_all(self) -> List[str]:
        """Drop every live and pending task (device failure): returns their
        ids so the caller can record the failures."""
        return [tid for tid, _c, _s in self.take_all()]
