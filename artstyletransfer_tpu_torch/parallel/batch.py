"""Batched multi-job style transfer: a job queue in lanes.

The port of the JAX package's ``parallel/batch.py``. The reference's
throughput model is "N independent jobs, at most 2 at a time on one GPU"
(reference config.py:1, task_executor.py:9,30). Here same-shape jobs are
STACKED into one batch: the JAX package vmaps its per-job step over a job
axis; the port writes that axis out as a leading lane axis B through the
whole step (engine/transfer.py): every VGG pass, Gram and TV kernel launch
serves all lanes at once, every loss is a (B,) vector reduced inside its
lane, Adam keeps per-lane moments under one step counter, and L-BFGS runs
the lanes' line searches in lockstep (engine/lbfgs.py lane forms). A live
batch (parallel/live.py) steps each lane from its own start step
(``chunk_steps``; the JAX package's ``batched_chunk_steps``).

Shape bucketing: a batch requires identical content shapes and identical
style shapes across jobs. ``bucket_jobs`` groups an arbitrary job queue
into such buckets; the canonicalize helpers collapse arbitrary inputs into
a few aspect buckets.

On CUDA a batch evaluates by replaying the captured evaluation of its
lane count (engine/graphs.py; the JAX package's ``_BATCH_CACHE``), shared
through engine/transfer.py's ``_COMPILE_CACHE`` with every job of the
same bucket, config and weights, so a queue's later rounds of a bucket
capture nothing; a convergence shrink moves to the graph of the smaller
size (``warm_shrink_graphs`` captures those ahead of time).

A batch checkpoints and resumes as a whole (engine/checkpoint.py), in the
middle of a convergence shrink too, and ``run_job_queue`` keeps one
checkpoint per group.

On a mesh (parallel/mesh.py) whose jobs axis is A, a batch is padded to a
multiple of A by replicating its last job, as the JAX package pads, and
split into A contiguous shards of lanes, one per jobs row: each shard is a
one-card batch with its own targets and captured graph, stepped in a host
thread of its own, and the shards meet at every chunk boundary
(parallel/shards.py). Losses and images are composed in lane order, a
convergence shrink re-forms the lanes over the shards (a lane may move to
another card), and a checkpoint holds the whole batch in lane order, the
file of an unsharded batch.

On a ('jobs', 'space') mesh with shard_space, each jobs row is a space
row of S devices (parallel/space.py): its batch (the shard of that row,
or the whole batch on a jobs axis of 1) holds each lane's image split by
rows over the S devices, as SpaceLanes, and so its gradients and its
optimizer state; one graph spans the row's devices and runs eagerly (no
CUDA graph spans cards). Where the level shapes do not pass
space.space_gate, a space row runs its lanes unsharded on its first
device and says why on stderr; without a mesh shard_space does nothing,
as in the JAX package. A shrink selects lanes within each block, and a
checkpoint holds the unsharded layout, so a space batch and an unsharded
one resume from each other's files.
"""

from __future__ import annotations

import hashlib
import os
import sys
import time
from collections import defaultdict
from functools import partial
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from ..config import Config, precision_gate
from ..engine.init_pipeline import build_init_image
from ..engine.pyramid import build_input_pyramids, level_shape
from ..engine import checkpoint as ckpt
from ..engine import graphs as graphs_mod
from ..engine.transfer import (HostCopies, LossGrad, _Adam, _Lbfgs,
                               _check_supported, _compute_targets,
                               _config_key,
                               _make_pyramid_loss, _make_space_pyramid_loss,
                               _raise_nonfinite_batch, async_steps,
                               eval_graph, lbfgs_history_fits,
                               lbfgs_history_gb, use_graphs, warn_lbfgs_hbm)
from ..models.weights import shared_params
from ..ops.resize import bicubic_resize_np
from ..utils.image import prepare_img, unprepare_img
from ..utils.metrics import span
from .mesh import check_mesh, jobs_axis, placement
from .shards import (Lanes, ShardedOpt, gather_lanes, run_on_shards,
                     shard_bounds, split_rows)
from .space import SpaceLanes, row_mesh, space_gate


def _select_targets(targets, idx: torch.Tensor):
    """Rows idx of every level's lane-stacked targets (the counterpart of
    the JAX package's _gather_rows on the targets)."""
    return tuple((content.index_select(0, idx),
                  tuple(g.index_select(0, idx) for g in grams))
                 for content, grams in targets)


def _gather(parts, rows: Sequence[int], device, space=None):
    """gather_lanes of `parts`, or of space rows' SpaceLanes pieces block
    by block onto the devices `space` of the space row they go to."""
    if not isinstance(parts[0], SpaceLanes):
        return gather_lanes(parts, rows, device)
    return SpaceLanes([gather_lanes([p.blocks[k] for p in parts], rows, dev)
                       for k, dev in enumerate(space)])


def _gather_targets(shard_targets, rows: Sequence[int], device, space=None):
    """Rows `rows` of the lane-stacked targets that `shard_targets` (one
    targets tuple per shard, in lane order) hold together, on `device`
    (a space row's content taps on the devices `space`)."""
    first = shard_targets[0]
    return tuple(
        (_gather([t[lvl][0] for t in shard_targets], rows, device, space),
         tuple(gather_lanes([t[lvl][1][k] for t in shard_targets], rows,
                            device) for k in range(len(first[lvl][1]))))
        for lvl in range(len(first)))


def lane_leaves(opt, batch: int) -> Dict[str, Any]:
    """An optimizer's named leaves (its leaf_specs's names: Adam's
    mu/nu/count, the whole L-BFGS lane state) with every leaf on a leading
    lane axis: a counter the lanes share (0-d) is spread over `batch`
    lanes. A sharded batch's leaves are Lanes, one piece per shard."""
    if isinstance(opt, ShardedOpt):
        return {name: (leaf if isinstance(leaf, Lanes)
                       else Lanes([leaf.expand(n) for n in opt.lanes]))
                for name, leaf in opt.shard_leaves().items()}
    return {name: leaf.expand(batch) if leaf.dim() == 0 else leaf
            for name, leaf in opt.leaves().items()}


def _gather_rows(leaves: Dict[str, Any],
                 rows: Sequence[int]) -> Dict[str, Any]:
    """Rows `rows` of every lane-axis leaf, each copied on its own device
    (the JAX package's _gather_rows over a batch's state)."""
    return {name: (leaf.take(list(rows)) if isinstance(leaf, Lanes)
                   else leaf.index_select(0, torch.as_tensor(
                       list(rows), dtype=torch.long, device=leaf.device)))
            for name, leaf in leaves.items()}


def shrink_target(n_still: int, jobs_axis: int = 1) -> int:
    """The batch size convergence shrinking re-forms `n_still` live jobs
    at: the next power of two, rounded up to a jobs-axis multiple (the
    JAX package's rule; on one card jobs_axis is 1)."""
    tgt = 1 << (n_still - 1).bit_length()
    return -(-tgt // jobs_axis) * jobs_axis


def shrink_ladder(size: int, jobs_axis: int = 1) -> List[int]:
    """Every batch size reachable from `size` by convergence shrinking
    (ascending), derived from shrink_target."""
    return sorted({t for t in (shrink_target(n, jobs_axis)
                               for n in range(1, size))
                   if t < size})


class BatchedTransferJob:
    """N same-shape style-transfer jobs as one batch of lanes.

    Runs on CUDA unless device='cpu' is passed; raises when CUDA is
    unavailable and the CPU was not asked for. params: repo-format numpy
    weights (HWIO); None resolves them from cfg.seed. Job i's noise init
    is seeded with cfg.seed + i, as in the JAX package. pad_batch_to
    replicates the last job up to that many lanes; padded results are
    dropped in run(). graphs: as TransferJob's (graph replay by default
    on CUDA, graphs=False eager).

    mesh (parallel/mesh.py): the batch is padded to a multiple of the
    jobs axis A and runs as A shards of lanes, one per jobs row's device
    (`device` may then only name that device type); `shards` holds them,
    None without a mesh or on a jobs axis of 1. Its images, losses and
    optimizer are then Lanes and a ShardedOpt (parallel/shards.py), and
    there is no `targets` of the whole batch.

    shard_space on a ('jobs', 'space') mesh: each jobs row's lanes split
    their rows over that row's S devices (parallel/space.py), where the
    level shapes pass space_gate; `space` is then the row's devices (of
    each shard, on a jobs axis above 1), the images are SpaceLanes and the
    evaluation runs eagerly (graphs=True raises). Each shard of a jobs
    axis above 1 is such a batch on its row's mesh (space.row_mesh)."""

    def __init__(self, contents: Sequence[np.ndarray],
                 styles: Sequence[np.ndarray], cfg: Config, params=None,
                 mesh=None, shard_space: bool = False,
                 init_overrides: Optional[Sequence[np.ndarray]] = None,
                 pad_batch_to: Optional[int] = None, device=None,
                 graphs: Optional[bool] = None):
        # a job's set-up: from here through run()'s init_opt
        self._setup = span("queue.job_setup")
        if len(contents) != len(styles) or not contents:
            raise ValueError("need one style per content and at least one "
                             "job")
        check_mesh(mesh)
        self.cfg = cfg
        self.mesh = mesh
        self.device = placement(mesh, device)
        _check_supported(cfg)
        n_space = (mesh.shape.get("space", 1)
                   if shard_space and mesh is not None else 1)

        c0 = contents[0].shape
        s0 = styles[0].shape
        for c, s in zip(contents, styles):
            if c.shape != c0 or s.shape != s0:
                raise ValueError("all jobs in a batch must share shapes; "
                                 "use bucket_jobs() to group them")

        self.real_batch = len(contents)
        contents = list(contents)
        styles = list(styles)
        init_overrides = list(init_overrides) if init_overrides else None
        if pad_batch_to is not None:
            while len(contents) < pad_batch_to:
                contents.append(contents[-1])
                styles.append(styles[-1])
                if init_overrides:
                    init_overrides.append(init_overrides[-1])
        axis = jobs_axis(mesh)
        while len(contents) % axis:  # a whole number of lanes per shard
            contents.append(contents[-1])
            styles.append(styles[-1])
            if init_overrides:
                init_overrides.append(init_overrides[-1])
        self.batch = len(contents)
        self.shards: Optional[List[BatchedTransferJob]] = None
        self.space: Optional[Tuple[torch.device, ...]] = None
        if axis > 1:
            self._init_shards(contents, styles, init_overrides, params,
                              graphs, n_space)
            return

        # per-job pyramids, stacked along the lane axis
        c_stack: List[List[np.ndarray]] = []
        s_stack: List[List[np.ndarray]] = []
        x0 = []
        for i, (c, s) in enumerate(zip(contents, styles)):
            c_lvls, s_lvls = build_input_pyramids(
                c, s, cfg.levels_num, cfg.base_diameter)
            c_stack.append([prepare_img(im) for im in c_lvls])
            s_stack.append([prepare_img(im) for im in s_lvls])
            if init_overrides is not None:
                init_img = init_overrides[i]
            else:
                init_img, _ = build_init_image(
                    cfg.init_method, c, s, cfg,
                    rng=np.random.default_rng(cfg.seed + i))
            x0.append(prepare_img(init_img).reshape(-1))

        self.level_shapes = [tuple(arr.shape) for arr in c_stack[0]]
        if n_space > 1:
            ok, why = space_gate(self.level_shapes, n_space)
            if ok:
                self.space = tuple(mesh.devices)
            else:
                print(f"space sharding: {why}; the batch's lanes run "
                      f"unsharded on {self.device}", file=sys.stderr)
        n_space = len(self.space) if self.space else 1
        if self.space and graphs:
            raise ValueError("graphs=True: a space batch runs eagerly (no "
                             "CUDA graph spans the cards of a space row)")
        self.graphs = use_graphs(self.device, False if self.space else graphs)
        params0 = shared_params(params, cfg.seed, self.device)
        # a space row's weights: one copy on each of its devices
        self.params = ([shared_params(params, cfg.seed, d)
                        for d in self.space] if self.space else params0)
        if cfg.optimizer == "lbfgs":
            warn_lbfgs_hbm(cfg, self.level_shapes, self.batch, n_space,
                           self.device)

        def lanes_on_device(stack, lvl):
            return torch.from_numpy(np.concatenate(
                [per_job[lvl] for per_job in stack])).to(self.device)

        n_levels = len(self.level_shapes)
        c_dev = [lanes_on_device(c_stack, lvl) for lvl in range(n_levels)]
        s_dev = [lanes_on_device(s_stack, lvl) for lvl in range(n_levels)]
        with precision_gate(cfg.conv_precision):
            self.targets = _compute_targets(params0, c_dev, s_dev, cfg)
        if self.space:
            # computed whole on the first device; the content taps are
            # split by the same rows as the image, the Grams stay there
            self._loss_fn = _make_space_pyramid_loss(self.level_shapes, cfg)
            self.targets = tuple(
                (SpaceLanes.split(content.reshape(content.shape[0], -1),
                                  self.space), grams)
                for content, grams in self.targets)
        else:
            self._loss_fn = _make_pyramid_loss(self.level_shapes, cfg)
        self._x0 = self._upload(torch.from_numpy(np.stack(x0)))  # (B, n)
        # ((B,) losses, (B, n) gradients) at x: the gradient of the
        # losses' sum, which is each lane's own gradient
        self._loss_grad = LossGrad(self, self.targets, self.graphs)

    def _upload(self, rows: torch.Tensor):
        """Host rows (B, n) of this one-card batch's layout: on its device,
        or split over its space row."""
        if self.space:
            return SpaceLanes.split(rows, self.space)
        return rows.to(self.device)

    def _init_shards(self, contents, styles, inits, params, graphs,
                     n_space: int = 1) -> None:
        """The shards of a batch on a mesh: one one-card batch per jobs row,
        built in its shard thread, from the lanes' init images (seeded by
        their index in the whole batch); on a space axis of n_space > 1
        each shard's lanes split over its row's devices."""
        cfg = self.cfg
        if inits is None:
            inits = [build_init_image(
                cfg.init_method, c, s, cfg,
                rng=np.random.default_rng(cfg.seed + i))[0]
                for i, (c, s) in enumerate(zip(contents, styles))]
        self._devices = self.mesh.jobs_devices()
        per = self.batch // len(self._devices)
        self.shards = run_on_shards(self._devices, [
            partial(_ONE_CARD, contents[a:b], styles[a:b], cfg,
                    params=params, init_overrides=inits[a:b], device=dev,
                    graphs=graphs,
                    mesh=row_mesh(self.mesh, i) if n_space > 1 else None,
                    shard_space=n_space > 1)
            for i, (dev, (a, b)) in enumerate(zip(
                self._devices, shard_bounds([per] * len(self._devices))))])
        self.level_shapes = self.shards[0].level_shapes
        self.graphs = self.shards[0].graphs
        self.space = self.shards[0].space
        self._x0 = Lanes([shard._x0 for shard in self.shards])

    def _on_shards(self, fn, *per_shard) -> list:
        """[fn(shard, *its items of per_shard)] over the shards, each in
        its shard thread."""
        return run_on_shards(self._devices, [
            partial(fn, shard, *items)
            for shard, *items in zip(self.shards, *per_shard)])

    def _capture_sizes(self, sizes) -> None:
        """Capture the evaluation of the first `size` lanes, for each size."""
        with precision_gate(self.cfg.conv_precision):
            for size in sizes:
                idx = torch.arange(size, device=self.device)
                eval_graph(self, _select_targets(self.targets, idx),
                           self._x0[:size])

    def warm_shrink_graphs(self) -> int:
        """Capture the evaluation of every smaller batch size that run()'s
        convergence shrinking can re-form this batch at (shrink_ladder;
        the counterpart of the JAX package's warm_shrink_gathers), so
        that no shrink captures mid-run; on a mesh, each shard's part of
        those sizes. Returns how many graphs it captured (sizes already
        cached capture nothing); 0 unless cfg.stop_tol and cfg.stop_shrink
        are set, graphs are on and the batch has more than one lane."""
        if not (self.cfg.stop_tol > 0.0 and self.cfg.stop_shrink
                and self.batch > 1 and self.graphs):
            return 0
        before = graphs_mod.CAPTURES
        if self.shards:
            axis = len(self.shards)
            sizes = [t // axis for t in shrink_ladder(self.batch, axis)]
            self._on_shards(_ONE_CARD._capture_sizes,
                            [sizes] * axis)
        else:
            self._capture_sizes(shrink_ladder(self.batch))
        return graphs_mod.CAPTURES - before

    def warm_live_chunk(self, n_steps: int) -> int:
        """Make sure the evaluation that a live chunk of this batch size
        replays exists (parallel/live.py). The JAX package compiles a
        per-lane-step chunk here; the port's live chunk replays the same
        (bucket, lanes) graph run() captures, whatever n_steps. Returns
        how many graphs it captured: 0 after a run() of this batch, and
        0 with graphs off."""
        del n_steps  # one captured evaluation serves every chunk length
        if not self.graphs:
            return 0
        before = graphs_mod.CAPTURES
        if self.shards:
            self._on_shards(_ONE_CARD._capture_sizes,
                            [[shard.batch] for shard in self.shards])
        else:
            self._capture_sizes([self.batch])
        return graphs_mod.CAPTURES - before

    def init_opt(self, x, leaves: Optional[Dict[str, Any]] = None,
                 targets=None):
        """The optimizer of x's (B, n) lanes against this batch's targets,
        or `targets` (the JAX package's _init_fn: L-BFGS evaluates x
        once), or one that continues from `leaves` (lane_leaves's form)
        without evaluating. On a mesh x is a Lanes with a piece per shard,
        leaves hold Lanes or host tensors of the whole batch, targets is
        one targets tuple per shard, and the result is a ShardedOpt."""
        if self.shards:
            bounds = shard_bounds([p.shape[0] for p in x.parts])
            per_leaves = [None] * len(bounds)
            if leaves is not None:
                split = {name: (leaf.parts if isinstance(leaf, Lanes)
                                else split_rows(leaf, bounds))
                         for name, leaf in leaves.items()}
                per_leaves = [{name: parts[i] for name, parts in split.items()}
                              for i in range(len(bounds))]
            opts = self._on_shards(_ONE_CARD.init_opt, x.parts, per_leaves,
                                   targets or [None] * len(bounds))
            return ShardedOpt(opts, [b - a for a, b in bounds])
        opt_cls = _Adam if self.cfg.optimizer == "adam" else _Lbfgs
        loss_grad = (self._loss_grad if targets is None
                     else LossGrad(self, targets, self.graphs))
        with precision_gate(self.cfg.conv_precision):
            return opt_cls(loss_grad, x, self.cfg, leaves)

    def chunk_steps(self, x, opt, start_steps: np.ndarray, n_steps: int):
        """n_steps optimizer steps of every lane, lane b from its own
        0-based step start_steps[b] (the JAX package's _chunk_steps_fn,
        its vmapped batched_chunk_steps): each lane keeps its own lr
        schedule and Adam bias correction. With a uniform vector this is
        run()'s chunk bit for bit. Returns (x, the (B,) losses at the
        chunk's last step); on a mesh both are Lanes."""
        steps = np.asarray(start_steps, np.int64)
        if self.shards:
            bounds = shard_bounds(opt.lanes)
            xs, fs = zip(*self._on_shards(
                _ONE_CARD.chunk_steps, x.parts, opt.opts,
                [steps[a:b] for a, b in bounds], [n_steps] * len(bounds)))
            return Lanes(xs), Lanes(fs)
        with precision_gate(self.cfg.conv_precision):
            for i in range(n_steps):
                x, f = opt.step(x, steps + i)
        return x, f

    def _steps(self, x, opt, done: int, k: int):
        """run()'s chunk: k steps of every lane from step `done`."""
        if self.shards:
            xs, fs = zip(*self._on_shards(
                _ONE_CARD._steps, x.parts, opt.opts,
                [done] * len(opt.opts), [k] * len(opt.opts)))
            return Lanes(xs), Lanes(fs)
        for i in range(k):
            x, f = opt.step(x, done + i)
        return x, f

    @torch.no_grad()
    def _losses_at(self, x, targets=None):
        """The (B,) total losses at x against this batch's targets, or
        `targets` (one tuple per shard on a mesh)."""
        if self.shards:
            return Lanes(self._on_shards(
                _ONE_CARD._losses_at, x.parts,
                targets or [None] * len(self.shards)))
        with precision_gate(self.cfg.conv_precision):
            total, _ = self._loss_fn(
                self.params, self.targets if targets is None else targets, x)
        return total

    def initial_losses(self) -> np.ndarray:
        """(real_batch,) total losses at the init images."""
        return self._losses_at(self._x0).cpu().numpy()[:self.real_batch]

    def _place(self, x_host: torch.Tensor):
        """A whole batch's host rows on the batch's device, or split over
        its shards (the layout of a batch of that many lanes)."""
        if not self.shards:
            return self._upload(x_host)
        axis = len(self.shards)
        if x_host.shape[0] % axis:
            raise ValueError(f"{x_host.shape[0]} lanes do not split over a "
                             f"jobs axis of {axis}")
        bounds = shard_bounds([x_host.shape[0] // axis] * axis)
        return Lanes([shard._upload(x_host[a:b])
                      for shard, (a, b) in zip(self.shards, bounds)])

    def _targets_of(self, lanes: Sequence[int]):
        """The construction targets of the given lanes, in that order: one
        tuple (one per shard of a batch of len(lanes) lanes on a mesh)."""
        if not self.shards:
            return _select_targets(self.targets, torch.as_tensor(
                list(lanes), dtype=torch.long, device=self.device))
        axis = len(self.shards)
        bounds = shard_bounds([len(lanes) // axis] * axis)
        return [_gather_targets([sh.targets for sh in self.shards],
                                lanes[a:b], sh.device, sh.space)
                for sh, (a, b) in zip(self.shards, bounds)]

    def _select_lanes(self, x, f, opt, targets, sel: List[int]):
        """Keep (and repeat) lanes `sel` of a running batch: its images,
        losses, optimizer state and targets. On a mesh the lanes re-form
        over the shards, and a lane may move to another card."""
        if not self.shards:
            idx = torch.as_tensor(sel, dtype=torch.long, device=x.device)
            x = x.index_select(0, idx)
            f = f.index_select(0, idx)
            opt.select(sel)
            targets = _select_targets(
                self.targets if targets is None else targets, idx)
            opt.loss_grad = LossGrad(self, targets, self.graphs)
            return x, f, opt, targets
        axis = len(self.shards)
        bounds = shard_bounds([len(sel) // axis] * axis)
        old = targets or [sh.targets for sh in self.shards]

        def regather(parts):
            # a leaf the optimizer keeps on the host stays there
            host = parts[0].device.type == "cpu"
            return Lanes([_gather(parts, sel[a:b],
                                  parts[0].device if host else sh.device,
                                  sh.space)
                          for sh, (a, b) in zip(self.shards, bounds)])

        x, f = regather(x.parts), regather(f.parts)
        leaves = {name: (regather(leaf.parts) if isinstance(leaf, Lanes)
                         else leaf)  # a counter the lanes share
                  for name, leaf in opt.shard_leaves().items()}
        targets = [_gather_targets(old, sel[a:b], sh.device, sh.space)
                   for sh, (a, b) in zip(self.shards, bounds)]
        return x, f, self.init_opt(x, leaves, targets), targets

    def run(self, iters_num: Optional[int] = None,
            stream_every: Optional[int] = None,
            checkpoint_path: Optional[str] = None,
            checkpoint_every: Optional[int] = None,
            resume: bool = False,
            yield_images: bool = True,
            ) -> Iterator[Tuple[int, np.ndarray, np.ndarray]]:
        """Yields (steps_done, images (B,H,W,3) [0,1]-domain, losses (B,))
        every stream_every steps, for the real (unpadded) jobs.

        yield_images=False skips the device->host image copy on
        intermediate chunks: those yield (done, None, losses), the losses
        as a device tensor over every lane (padding included; on a mesh a
        host tensor) unless a convergence check already fetched them; the
        final chunk always carries the images.
        When images are streamed, cfg.pipeline_streaming (default on)
        yields chunk k only after chunk k+1 was dispatched, as
        TransferJob.run does (HostCopies; Adam only, and off under
        cfg.stop_tol, whose check reads each chunk's losses before the
        next one).

        cfg.stop_tol > 0: a job whose relative loss change over a chunk is
        <= stop_tol is done (latched). With cfg.stop_shrink a done job
        leaves the batch at the chunk boundary (its result freezes there)
        and the remaining lanes re-form at shrink_target's size (a
        multiple of the jobs axis on a mesh) by index_select on every
        state tensor; without it the batch stops once every job has
        converged.

        checkpoint_path / checkpoint_every / resume: as TransferJob.run,
        for the whole batch. After a shrink the file holds the live lanes;
        its extra carries the lane composition, the stop bookkeeping and
        the frozen jobs' losses, its aux their frozen rows, so a resume
        continues at the shrunken size bit for bit. On a mesh the file
        holds the lanes in order, as an unsharded batch's does.
        """
        cfg = self.cfg
        iters = iters_num if iters_num is not None else cfg.iters_num
        chunk = stream_every if stream_every is not None else cfg.stream_every
        chunk = max(1, min(chunk, iters))
        axis = len(self.shards) if self.shards else 1
        # the construction batch size keys the fingerprint; a shrunken
        # state's own size rides in the extra's lane composition
        fp = str(("batched", self.batch)
                 + _config_key(cfg, self.level_shapes))
        opt_cls = _Adam if cfg.optimizer == "adam" else _Lbfgs

        targets = None  # the construction targets; shrinking selects lanes

        x = self._x0.clone()
        done = 0
        top = self.level_shapes[0]  # (1, H, W, 3) per job
        check_stop = cfg.stop_tol > 0.0
        shrink = check_stop and cfg.stop_shrink
        # lane -> original job index; None = padding replica
        lane_orig: List[Optional[int]] = (
            list(range(self.real_batch))
            + [None] * (self.batch - self.real_batch))
        # lane -> the job whose targets the lane carries (padding replicas
        # carry the job they copy): what a resume selects the targets by
        lane_src: List[int] = (
            list(range(self.real_batch))
            + [self.real_batch - 1] * (self.batch - self.real_batch))
        finished: Dict[int, Tuple[np.ndarray, float]] = {}  # orig -> row, loss
        f_prev: Dict[int, float] = {}  # orig -> last chunk's loss
        # convergence latches per job: once a job's chunk change dips under
        # tol it is done, even if later chunks oscillate back over tol
        latched: set = set()

        def lane_of():
            return {orig: lane for lane, orig in enumerate(lane_orig)
                    if orig is not None}

        def compose_losses(f_np):
            # original-order (real_batch,) losses: live lanes from the
            # batch, dropped jobs from their frozen value
            lanes = lane_of()
            out = np.empty((self.real_batch,), dtype=np.float32)
            for orig in range(self.real_batch):
                out[orig] = (finished[orig][1] if orig in finished
                             else f_np[lanes[orig]])
            return out

        def materialize(done_k, x_k, f_k):
            with span("engine.materialize"):
                rows = x_k.cpu().numpy().reshape(
                    (len(lane_orig),) + top[1:])
                lanes = lane_of()
                imgs_k = np.stack([
                    unprepare_img(finished[orig][0] if orig in finished
                                  else rows[lanes[orig]])
                    for orig in range(self.real_batch)])
                losses_k = compose_losses(f_k.cpu().numpy())
            if cfg.nan_checks and not np.isfinite(losses_k).all():
                bad = np.flatnonzero(~np.isfinite(losses_k)).tolist()
                _raise_nonfinite_batch(bad, done_k, self.real_batch, cfg)
            return done_k, imgs_k, losses_k

        def save(converged):
            extra: Optional[Dict[str, Any]] = None
            aux = None
            if check_stop:
                # JSON keys are strings; f_prev's int keys restore below
                extra = {"f_prev": {str(k): v for k, v in f_prev.items()},
                         "latched": sorted(latched), "converged": converged}
            if shrink:
                extra.update(lane_orig=lane_orig, lane_src=lane_src,
                             finished=[[orig, loss] for orig, (_row, loss)
                                       in sorted(finished.items())])
                if finished:
                    aux = {"finished_rows": np.stack(
                        [row for _o, (row, _l) in sorted(finished.items())])}
            ckpt.save_checkpoint(checkpoint_path, x.cpu(), opt.leaves(), done,
                                 fingerprint=fp, extra=extra, aux=aux)

        leaves = None
        if resume and checkpoint_path and os.path.exists(checkpoint_path):
            # a shrunken batch's size is only known from the file's extra
            _step, peek = ckpt.peek_checkpoint_meta(checkpoint_path)
            if peek.get("lane_orig") is not None:
                lane_orig = [None if v is None else int(v)
                             for v in peek["lane_orig"]]
                lane_src = [int(v) for v in peek["lane_src"]]
            cur = len(lane_orig)
            x_saved, leaves, done, ck_extra, ck_aux = ckpt.load_checkpoint(
                checkpoint_path, opt_cls.leaf_specs(cfg, cur, x.shape[1]),
                fingerprint=fp, with_extra=True, with_aux=True)
            x = self._place(x_saved)
            f_prev = {int(k): v
                      for k, v in ck_extra.get("f_prev", {}).items()}
            latched = set(ck_extra.get("latched", ()))
            for i, (orig, loss) in enumerate(ck_extra.get("finished", [])):
                finished[int(orig)] = (ck_aux["finished_rows"][i].numpy(),
                                       float(loss))
            if cur != self.batch:
                targets = self._targets_of(lane_src)
            if done >= iters or ck_extra.get("converged"):
                # a finished batch: its final images, and the live lanes'
                # losses at them beside the frozen jobs' own
                yield materialize(done, x, self._losses_at(x, targets))
                return
        with self._setup:
            opt = self.init_opt(x, leaves, targets)
        last_saved = done
        lookahead = yield_images and async_steps(cfg) and not check_stop
        copies = HostCopies()

        while done < iters:
            with precision_gate(cfg.conv_precision):  # released at the yield
                k = min(chunk, iters - done)
                with span("engine.chunk", steps=k):
                    x, f = self._steps(x, opt, done, k)
                done += k
                converged = False
                f_np = None
                if check_stop:
                    f_np = f.cpu().numpy()
                    # a NaN can never satisfy the convergence test:
                    # surface it now instead of burning the remaining budget
                    if cfg.nan_checks:
                        bad = [orig for lane, orig in enumerate(lane_orig)
                               if orig is not None
                               and not np.isfinite(f_np[lane])]
                        if bad:
                            _raise_nonfinite_batch(bad, done,
                                                   self.real_batch, cfg)
                    ready = []   # (lane, orig, loss): latched, still in batch
                    still = []   # lanes of real jobs not yet converged
                    for lane, orig in enumerate(lane_orig):
                        if orig is None:
                            continue
                        cur = float(f_np[lane])
                        prev = f_prev.get(orig)
                        if (orig in latched
                                or (prev is not None
                                    and abs(prev - cur)
                                    <= cfg.stop_tol * max(1.0, abs(cur)))):
                            latched.add(orig)
                            ready.append((lane, orig, cur))
                        else:
                            still.append(lane)
                        f_prev[orig] = cur
                    if ready and not still:
                        converged = True  # every remaining job is done
                    elif ready and still and shrink and done < iters:
                        tgt = shrink_target(len(still), axis)
                        if tgt < len(lane_orig):
                            # freeze the converged jobs' results now, then
                            # keep the remaining lanes, re-padded by
                            # repeating the last one
                            for lane, orig, cur in ready:
                                finished[orig] = (
                                    x[lane].cpu().numpy().reshape(top[1:]),
                                    cur)
                            sel = still + [still[-1]] * (tgt - len(still))
                            print(f"stop_tol: {len(ready)} job(s) converged at "
                                  f"step {done}; batch {len(lane_orig)} -> "
                                  f"{tgt}", file=sys.stderr)
                            x, f, opt, targets = self._select_lanes(
                                x, f, opt, targets, sel)
                            f_np = f_np[sel]
                            lane_orig = ([lane_orig[ln] for ln in still]
                                         + [None] * (tgt - len(still)))
                            lane_src = [lane_src[ln] for ln in sel]
                if (checkpoint_path and checkpoint_every
                        and (done - last_saved >= checkpoint_every
                             or done >= iters or converged)):
                    save(converged)
                    last_saved = done
                if lookahead:
                    out = None  # streamed a chunk later, below
                elif yield_images or done >= iters or converged:
                    out = materialize(done, x, f)
                elif f_np is not None:
                    out = done, None, compose_losses(f_np)
                else:
                    out = done, None, f.cpu() if self.shards else f
            if lookahead:
                yield from copies.after_chunk(done, x, f, done >= iters,
                                              materialize)
                continue
            yield out
            if converged:
                return


# the class a sharded batch builds its shards with (a caller that patches
# the module's BatchedTransferJob sees one batch, not its shards too)
_ONE_CARD = BatchedTransferJob


def bucket_jobs(jobs: Sequence[Tuple[str, np.ndarray, np.ndarray]]
                ) -> Dict[tuple, List[Tuple[str, np.ndarray, np.ndarray]]]:
    """Group (task_id, content, style) jobs by (content.shape, style.shape)."""
    buckets: Dict[tuple, list] = defaultdict(list)
    for job in jobs:
        buckets[(job[1].shape, job[2].shape)].append(job)
    return dict(buckets)


# Canonical aspect ratios (w/h) for content bucketing in serving mode.
DEFAULT_ASPECT_BUCKETS = (1.0, 4 / 3, 3 / 4, 16 / 9, 9 / 16, 3 / 2, 2 / 3)


def bucket_content_shape(aspect: float, cfg: Config) -> tuple:
    """(h, w) of the canonical content shape for an aspect bucket (w/h):
    shortest side = base_diameter * 2^(levels-1)."""
    side = cfg.base_diameter * 2 ** (cfg.levels_num - 1)
    if aspect >= 1.0:
        return side, int(round(side * aspect))
    return int(round(side / aspect)), side


def crop_to_aspect_bucket(img: np.ndarray,
                          aspects: Sequence[float] = DEFAULT_ASPECT_BUCKETS
                          ) -> np.ndarray:
    """Center-crop an HWC image to the nearest canonical aspect ratio, so
    jobs whose contents land in the same aspect bucket share a batch."""
    h, w = img.shape[:2]
    target = min(aspects, key=lambda a: abs(a - w / h))
    if w / h > target:
        new_w = int(round(h * target))
        off = (w - new_w) // 2
        img = img[:, off:off + new_w]
    else:
        new_h = int(round(w / target))
        off = (h - new_h) // 2
        img = img[off:off + new_h, :]
    return np.ascontiguousarray(img)


def canonicalize_content(content: np.ndarray, cfg: Config) -> np.ndarray:
    """Center-crop to the nearest canonical aspect bucket and resize to that
    bucket's exact top-pyramid-level shape (lossless for the pipeline:
    resolution above the top level is never used). The target shape comes
    from the bucket's exact ratio, not the crop's rounded one."""
    h, w = content.shape[:2]
    target = min(DEFAULT_ASPECT_BUCKETS, key=lambda a: abs(a - w / h))
    c = crop_to_aspect_bucket(content, aspects=(target,))
    th, tw = bucket_content_shape(target, cfg)
    return bicubic_resize_np(c, th, tw)


def canonicalize_style(style: np.ndarray, cfg: Config) -> np.ndarray:
    """Resize a style image to a square of the level-0 base diameter; style
    images only contribute Gram statistics, so the distortion is mild and
    jobs sharing a content bucket share a batch whatever their style's
    aspect ratio."""
    side = cfg.base_diameter
    return bicubic_resize_np(style, side, side)


def resolve_batch_policy(cfg: Config, batch_policy: str = "auto") -> str:
    """Resolve 'auto' to 'batched' | 'sequential' for a job queue.

    The JAX package's routing, not yet measured on this card: lr-opening
    full-Wolfe L-BFGS runs one job at a time (batched, the lanes' line
    searches run in lockstep at the longest search of the batch), while
    Adam, reference-semantics L-BFGS (max_ls=0, a fixed-length search) and
    unit-opening full-Wolfe (lbfgs_t_init='unit': most lanes accept the
    first trial) batch.
    """
    if batch_policy != "auto":
        if batch_policy not in ("batched", "sequential"):
            raise ValueError(f"unknown batch_policy {batch_policy!r}; "
                             "expected 'auto', 'batched' or 'sequential'")
        return batch_policy
    if (cfg.optimizer == "lbfgs" and cfg.lbfgs_max_ls_steps > 0
            and cfg.lbfgs_t_init != "unit"):
        return "sequential"
    return "batched"


# The JAX package's value, not yet measured on this card: the batch size
# past which job-steps/s stopped improving on one TPU chip. The history
# budget is engine/transfer.py's lbfgs_history_fits.
_SATURATION_BATCH = 32


def max_jobs_per_batch(cfg: Config, content_shape: tuple,
                       space: int = 1, device=None) -> int:
    """Memory-aware cap on jobs per batch for one bucket: the most jobs
    whose L-BFGS history pairs (2 * history * n_pixels values per job, 4
    or 2 bytes each; a card's share over a space row of `space` cards)
    fit the history budget of `device` beside their evaluation
    (lbfgs_history_fits; at least one), and the saturation batch."""
    if cfg.optimizer != "lbfgs":
        return _SATURATION_BATCH
    h, w = level_shape(content_shape[0], content_shape[1],
                       cfg.levels_num - 1, cfg.base_diameter)
    shapes = [(1, h, w, 3)]
    cap = 1
    while cap < _SATURATION_BATCH and lbfgs_history_fits(
            cfg, shapes, cap + 1, space, device):
        cap += 1
    return cap


def bucket_space(cfg: Config, content_shape: tuple, n_space: int) -> int:
    """The space axis a bucket's batches shard their rows over: n_space
    where its level shapes pass space.space_gate, else 1."""
    if n_space < 2:
        return 1
    shapes = [(1,) + level_shape(content_shape[0], content_shape[1], lvl,
                                 cfg.base_diameter) + (3,)
              for lvl in reversed(range(cfg.levels_num))]
    return n_space if space_gate(shapes, n_space)[0] else 1


def resolve_group_cap(cfg: Config, content_shape: tuple, jobs_axis: int,
                      policy: str, max_batch: Optional[int],
                      space: int = 1, device=None) -> int:
    """Jobs per group for one bucket (see run_job_queue). An explicit
    max_batch is a literal total cap, rounded down to a multiple of the
    jobs axis (1 on one card). space: the space axis the bucket's rows
    shard over (bucket_space), which divides each card's history; device:
    the card whose memory bounds it (max_jobs_per_batch)."""
    if policy == "sequential":
        return 1
    if max_batch is not None:
        cap = max_batch
        if jobs_axis > 1 and cap >= jobs_axis:
            cap -= cap % jobs_axis
        return max(1, cap)
    return max_jobs_per_batch(cfg, content_shape, space, device) * jobs_axis


def planned_round_sizes(cfg: Config, content_shape: tuple, n_jobs: int,
                        jobs_axis: int = 1, policy: str = "auto",
                        max_batch: Optional[int] = None,
                        pad_batches: bool = True) -> list:
    """The batch sizes run_job_queue dispatches for a single-bucket queue of
    n_jobs same-shape jobs: the policy routing, the group cap, the
    power-of-two pad rule and, with stop_shrink, the shrink ladder."""
    policy = resolve_batch_policy(cfg, policy)
    cap = resolve_group_cap(cfg, content_shape, jobs_axis, policy, max_batch)
    sizes = set()
    remaining = n_jobs
    while remaining > 0:
        g = min(remaining, cap)
        remaining -= g
        size = g
        if pad_batches and policy != "sequential":
            pad_to = min(cap, 1 << (g - 1).bit_length())
            if pad_to > g:
                size = pad_to
        if policy != "sequential" and jobs_axis > 1:
            size = -(-size // jobs_axis) * jobs_axis
        sizes.add(size)
    if cfg.stop_tol > 0.0 and cfg.stop_shrink and policy != "sequential":
        for size in list(sizes):
            sizes.update(shrink_ladder(size, jobs_axis))
    return sorted(sizes)


def run_job_queue(jobs: Sequence[Tuple[str, np.ndarray, np.ndarray]],
                  cfg: Config, params=None, mesh=None,
                  shard_space: bool = False, progress=None,
                  canonicalize_styles: bool = False,
                  canonicalize_contents: bool = False,
                  batch_policy: str = "auto",
                  max_batch: Optional[int] = None,
                  pad_batches: bool = False,
                  stream_images: bool = True,
                  checkpoint_dir: Optional[str] = None,
                  checkpoint_every: Optional[int] = None,
                  resume: bool = False,
                  retries: int = 0,
                  retry_delay_s: float = 25.0,
                  device=None,
                  on_start: Optional[Callable[[List[str]], None]] = None,
                  ) -> Tuple[Dict[str, np.ndarray], Dict[str, Exception]]:
    """Run an arbitrary job queue: bucket by shape, batch each bucket in
    lanes, stream progress.

    Returns ({task_id: final image}, {task_id: exception}): a failed group
    (e.g. out of memory at an extreme shape) is isolated, its task_ids land
    in the failures dict and the rest of the queue runs.

    batch_policy ('auto' default) routes as resolve_batch_policy says:
    'sequential' runs groups of one job. Oversized buckets split into
    groups of at most max_batch jobs (default max_jobs_per_batch).
    canonicalize_styles squares every style to the base diameter, and
    canonicalize_contents crops and resizes contents to their aspect
    bucket, so that mixed inputs share batches. pad_batches=True pads every
    batched group up to the next power of two (capped by the group cap) by
    replicating jobs whose results are dropped. stream_images=False skips
    the per-chunk image copy (progress then receives images=None except
    for the final chunk). retries re-runs a failed group up to that many
    extra times after retry_delay_s. progress(task_id, percent, image,
    loss) is called per job and chunk, and on_start(task_ids) as each
    group starts. Runs on CUDA unless device='cpu'.

    checkpoint_dir: each group checkpoints its whole batch every
    checkpoint_every steps (default stream_every) to
    `<dir>/queue_<sha1 of the group's task ids>.ckpt`. resume=True picks
    every group of the same queue up from its file (a finished group
    returns its images without running again); without it a file left by
    an earlier run is removed first. A retry resumes from the group's last
    save.

    mesh (parallel/mesh.py): each batched group runs over the mesh's jobs
    axis A. The automatic group cap is the one-card cap times A, an
    explicit max_batch is rounded down to a multiple of A, and a group is
    padded to a multiple of A; a 'sequential' group of one job runs
    without the mesh (on its first device), not padded over A cards, as
    in the JAX package. shard_space: each group's jobs also split their
    rows over the mesh's space axis (BatchedTransferJob), and the cap
    counts each card's share of the history; a sequential group without
    the mesh runs unsharded, as in the JAX package.
    """
    check_mesh(mesh)
    dev = placement(mesh, device)
    if checkpoint_dir is not None and checkpoint_every is None:
        checkpoint_every = cfg.stream_every  # the CLI's default too
    if checkpoint_dir is not None and cfg.optimizer == "lbfgs" and jobs:
        # a save copies the whole L-BFGS state to the host and to disk
        h0, w0 = level_shape(jobs[0][1].shape[0], jobs[0][1].shape[1],
                             cfg.levels_num - 1, cfg.base_diameter)
        state_gb = lbfgs_history_gb(cfg, [(1, h0, w0, 3)])
        if state_gb > 1.0 and checkpoint_every <= 5 * cfg.stream_every:
            print(f"warning: each checkpoint save copies ~{state_gb:.1f} GB "
                  f"of L-BFGS state per job; at --checkpoint-every "
                  f"{checkpoint_every} that dominates the run. Consider "
                  f"--checkpoint-every {max(200, 20 * cfg.stream_every)} "
                  f"or --lbfgs-history 10.", file=sys.stderr)
    if canonicalize_contents:
        jobs = [(tid, canonicalize_content(c, cfg), s) for tid, c, s in jobs]
    if canonicalize_styles:
        jobs = [(tid, c, canonicalize_style(s, cfg)) for tid, c, s in jobs]

    policy = resolve_batch_policy(cfg, batch_policy)
    results: Dict[str, np.ndarray] = {}
    failures: Dict[str, Exception] = {}
    # the one-card cap is per card: a jobs axis of A takes A times as
    # many jobs, and a group is a multiple of A or its padding replicas
    # would exceed the budget the cap keeps
    axis = jobs_axis(mesh)
    n_space = (mesh.shape.get("space", 1)
               if shard_space and mesh is not None else 1)
    for bucket in bucket_jobs(jobs).values():
        cap = resolve_group_cap(
            cfg, bucket[0][1].shape, axis, policy, max_batch,
            bucket_space(cfg, bucket[0][1].shape, n_space), dev)
        groups = [bucket[i:i + cap] for i in range(0, len(bucket), cap)]
        for group in groups:
            ids = [j[0] for j in group]
            if on_start is not None:
                on_start(ids)
            # a sequential group of one job is not padded over the jobs
            # axis (A - 1 replicas, and the lockstep the routing avoids)
            group_mesh = mesh if (policy != "sequential"
                                  or axis == 1) else None
            group_dev = None if group_mesh is not None else dev
            ckpt_path = None
            if checkpoint_dir is not None:
                os.makedirs(checkpoint_dir, exist_ok=True)
                tag = hashlib.sha1(",".join(ids).encode()).hexdigest()[:16]
                ckpt_path = os.path.join(checkpoint_dir, f"queue_{tag}.ckpt")
                if not resume and os.path.exists(ckpt_path):
                    # a file of an earlier run: a retry below resumes, and
                    # must not load it
                    os.remove(ckpt_path)
            pad_to = None
            if pad_batches and policy != "sequential":
                pad_to = min(cap, 1 << (len(group) - 1).bit_length())
                if pad_to <= len(group):
                    pad_to = None
            last_exc: Optional[Exception] = None
            for attempt in range(retries + 1):
                if attempt:
                    print(f"run_job_queue: group of {len(ids)} job(s) "
                          f"failed ({type(last_exc).__name__}: {last_exc});"
                          f" retry {attempt}/{retries} in "
                          f"{retry_delay_s:.0f}s", file=sys.stderr)
                    time.sleep(retry_delay_s)
                with span("queue.group", task=tuple(ids), lanes=0,
                          pad_lanes=0, attempt=attempt) as attempt_span:
                    try:
                        batch = BatchedTransferJob(
                            [j[1] for j in group], [j[2] for j in group],
                            cfg, params=params, mesh=group_mesh,
                            shard_space=(shard_space
                                         and group_mesh is not None),
                            pad_batch_to=pad_to, device=group_dev)
                        attempt_span.set(
                            lanes=batch.batch,
                            pad_lanes=batch.batch - batch.real_batch)
                        imgs = None
                        for done, imgs, losses in batch.run(
                                yield_images=stream_images,
                                checkpoint_path=ckpt_path,
                                checkpoint_every=checkpoint_every,
                                # a retry resumes from the last save
                                resume=resume or attempt > 0):
                            if progress is not None:
                                pct = done / cfg.iters_num * 100.0
                                # one device->host read for the batch
                                losses = np.asarray(
                                    losses.cpu() if torch.is_tensor(losses)
                                    else losses)
                                for i, tid in enumerate(ids):
                                    progress(tid, pct,
                                             imgs[i] if imgs is not None
                                             else None,
                                             float(losses[i]))
                        if imgs is None:
                            raise RuntimeError(
                                f"batch of {len(ids)} job(s) yielded no "
                                f"chunks (iters_num={cfg.iters_num})")
                        if (progress is not None and cfg.stop_tol > 0.0
                                and done < cfg.iters_num):
                            # an early stop ended the group below the
                            # budget; consumers key completion on
                            # percent >= 100
                            for i, tid in enumerate(ids):
                                progress(tid, 100.0, imgs[i],
                                         float(losses[i]))
                        for i, tid in enumerate(ids):
                            results[tid] = imgs[i]
                        last_exc = None
                        break
                    except Exception as e:  # noqa: BLE001 — group isolation
                        # one bad group (e.g. out of memory at an extreme
                        # shape) must not kill the rest of the queue
                        last_exc = e
            if last_exc is not None:
                for tid in ids:
                    failures[tid] = last_exc
    if failures:
        print(f"run_job_queue: {len(failures)} job(s) failed: "
              + ", ".join(f"{tid}: {type(e).__name__}: {e}"
                          for tid, e in sorted(failures.items())),
              file=sys.stderr)
    return results, failures
