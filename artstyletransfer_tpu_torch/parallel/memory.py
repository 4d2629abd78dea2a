"""The device memory one batched step needs, on each card.

The counterpart of the JAX package's ``parallel/memory.py``
(``aot_memory_stats``), which compiles the batched chunk ahead of time and
reads XLA's memory analysis. PyTorch has no such analysis, so the port
counts what a step holds:

- ``argument_bytes``: what lives across steps, the weights, the targets,
  the (B, n) images and the optimizer state (Adam's moments, or the whole
  L-BFGS lane state with its s/y history), from their shapes;
- ``saved_activation_bytes``: what autograd keeps from the forward of one
  evaluation for its backward, counted with
  ``torch.autograd.graph.saved_tensors_hooks`` (each storage once, the
  arguments left out). With ``cfg.remat_levels`` the level passes keep
  only their input images and the forward saves little else; the
  activations of one level are recomputed while its backward runs, and
  the largest level's are ``recompute_peak_bytes`` (0 without remat);
- on CUDA, ``peak_bytes``: ``torch.cuda.max_memory_allocated()`` over one
  evaluation (captured as a CUDA graph, its two eager warm passes
  included) and one optimizer step, after ``reset_peak_memory_stats()``,
  beside ``allocated_before_bytes``, what was allocated when it started
  (the job's arguments, and whatever else the process holds).

argument + saved + recompute_peak is the prediction; the measured peak
adds what the backward and the convolutions hold for a moment.

The counts are the same on the CPU and the card. They are taken on one
and on two lanes and extrapolated to the batch, which is exact: every
saved tensor carries the lane axis except the pyramid's resize matrices,
which do not grow with it. So the count never holds more than two lanes'
activations, and a batch too large for the card can be predicted on it.

On a jobs mesh (parallel/mesh.py) each card holds one shard of the batch
padded to a multiple of the jobs axis A: the counts are those of
``lanes_per_card`` = ceil(batch / A) lanes, and on CUDA ``per_card``
lists each shard's device with the peak measured there over the same
evaluation and step of the sharded batch, each shard in its own thread
(a mesh that names one card twice measures both shards' peak on it).

With shard_space on a ('jobs', 'space') mesh whose level shapes pass
parallel/space.py's gate, each lane's rows split over a space row of S
devices, and the counts are per shard of that row, a mesh entry (so a
mesh that names one device S times still reports each block apart):
``per_shard`` lists, for each block, its weight, target and state bytes
(the images and optimizer state: the pixel-axis leaves' block, and the
scalars and carried Grams on the first device), its argument bytes, and
the activations autograd saves for its rows (on distinct cards the
storages on its card; where the row names one device more than once,
those saved while its forward is built: a node over every block, the TV
with the level images and the Grams' sum, counts on the first shard).
The top-level counts are the largest shard's. On CUDA ``per_card`` gives the peak measured on
each distinct card of the rows.
"""

from __future__ import annotations

from functools import partial
from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from ..config import Config, precision_gate
from ..engine.pyramid import resize_to_level
from ..engine.transfer import (_Adam, _Lbfgs, drop_graph, level_pass,
                               space_level_pass)
from ..ops.resize import downscale2x, downscale2x_blocks
from .batch import BatchedTransferJob, _select_targets
from .mesh import check_mesh, jobs_axis, placement
from .shards import run_on_shards
from ..ops.blocks import current_block
from .space import SpaceLanes, row_mesh


def _nbytes(tensors: Iterable[torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _blocks(t) -> list:
    """The tensors a batch's value is made of: a space row's blocks, or
    the tensor itself."""
    return list(t.blocks) if isinstance(t, SpaceLanes) else [t]


def _weights(job) -> list:
    """Each shard's weights (one set without a space row)."""
    per = job.params if job.space else [job.params]
    return [[t for layer in p.values() for t in layer.values()] for p in per]


def _argument_tensors(job):
    """The weights, targets and initial images of a batch."""
    yield from (t for w in _weights(job) for t in w)
    for content, grams in job.targets:
        yield from _blocks(content)
        yield from grams
    yield from _blocks(job._x0)


def _saved_bytes(fn, exclude, space=None) -> list:
    """Bytes of the storages autograd saves while fn() runs, each storage
    once, those in `exclude` (data pointers) left out, per block of the
    space row `space` (its devices): the block of the storage's device
    where they are distinct (the first block for a host tensor), else
    ops/blocks.py current_block when the storage is first saved (one entry
    without a space row). fn's graph is never run backward: the
    hook keeps each saved storage alive until the count is done (so no
    freed storage's address is reused meanwhile) and gives autograd
    nothing back, since a saved output handed back to its own node would
    make a reference cycle that is never freed."""
    space = space or ()
    kept = [{} for _ in range(max(1, len(space)))]
    owner = ({d: k for k, d in enumerate(space)}
             if len(set(space)) == len(space) > 1 else None)
    seen = set(exclude)

    def pack(t):
        storage = t.untyped_storage()
        if storage.data_ptr() not in seen:
            seen.add(storage.data_ptr())
            k = owner.get(t.device, 0) if owner else current_block()
            kept[k][storage.data_ptr()] = storage

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda _: None):
        fn()
    return [sum(st.nbytes() for st in k.values()) for k in kept]


def _count(job, lanes: int) -> Tuple[int, int]:
    """(saved_activation_bytes, recompute_peak_bytes) of one evaluation
    of the first `lanes` lanes of `job` (a space row's summed over its
    blocks)."""
    saved, peak = _count_blocks(job, lanes)
    return sum(saved), sum(peak)


def _count_blocks(job, lanes: int) -> Tuple[list, list]:
    """_count per block of job's space row: two lists with one entry per
    block (one entry without a space row)."""
    cfg = job.cfg
    n = len(job.space) if job.space else 1
    idx = torch.arange(lanes, device=job.device)
    targets = _select_targets(job.targets, idx)
    x0 = job._x0[:lanes]
    xs = [b.clone().requires_grad_(True) for b in _blocks(x0)]
    x = SpaceLanes(xs) if job.space else xs[0]
    exclude = {t.untyped_storage().data_ptr()
               for t in (*_argument_tensors(job), *xs)}
    exclude |= {t.untyped_storage().data_ptr() for content, grams in targets
                for t in (*_blocks(content), *grams)}
    with precision_gate(cfg.conv_precision):
        saved = _saved_bytes(
            lambda: job._loss_fn(job.params, targets, x), exclude, job.space)
        if not cfg.remat_levels:
            return saved, [0] * n
        # each level's pass as its recomputation runs it, its input image
        # (held by the checkpoint, counted above) left out
        peak = [0] * n
        shape = job.level_shapes[0][1:]
        with torch.no_grad():
            cur = [b.detach().reshape((lanes, shape[0] // n) + shape[1:])
                   for b in xs]
        for lvl in range(len(job.level_shapes)):
            if lvl > 0:
                with torch.no_grad():
                    cur = (downscale2x_blocks(cur) if job.space
                           else [downscale2x(cur[0])])
            imgs = [c.detach().requires_grad_(True) for c in cur]
            if job.space:
                def run(lvl=lvl, imgs=imgs):
                    return space_level_pass(job.params, targets, lvl, imgs,
                                            cfg)
            else:
                def run(lvl=lvl, imgs=imgs):
                    return level_pass(job.params, targets, lvl, imgs[0], cfg)
            level = _saved_bytes(run, exclude | {
                i.untyped_storage().data_ptr() for i in imgs}, job.space)
            peak = [max(a, b) for a, b in zip(peak, level)]
        return saved, peak


def _state_bytes(job, opt_cls, lanes: int) -> list:
    """Per block of the space row (one entry without one): the images'
    and the optimizer state's bytes; a leaf over the pixels splits with
    them, every other leaf is on the first device."""
    n = len(job.space) if job.space else 1
    pixels = job._x0.shape[1]
    out = [lanes * pixels * job._x0.dtype.itemsize // n] * n
    for spec in opt_cls.leaf_specs(job.cfg, lanes, pixels).values():
        size = spec.numel() * spec.element_size()
        if spec.dim() >= 2 and spec.shape[-1] == pixels:
            out = [o + size // n for o in out]
        else:
            out[0] += size
    return out


def memory_stats(cfg: Config, content_hw: Tuple[int, int], batch: int = 1,
                 device=None, mesh=None, shard_space: bool = False,
                 limit_bytes: Optional[int] = None) -> dict:
    """The memory one batched step of `batch` lanes at content_hw needs
    (see the module docstring), in bytes. Builds a BatchedTransferJob of
    seeded (content, style) pairs at content_hw, each lane's content at
    the top level as its init image (the init's noise does not change the memory). Runs
    on CUDA unless device='cpu'; on CUDA it also measures peak_bytes,
    unless limit_bytes is given and the prediction exceeds it (then
    peak_bytes is None). The measurement captures the evaluation anew:
    the cached graph of this job's key is dropped before and after.
    mesh: the counts are per card, for lanes_per_card lanes (see the
    module docstring). shard_space on a mesh with a space axis: the counts
    are per shard of a space row (see the module docstring); without a
    mesh it does nothing, as in BatchedTransferJob."""
    check_mesh(mesh)
    dev = placement(mesh, device)
    axis = jobs_axis(mesh)
    lanes = -(-batch // axis)  # per card, the batch padded to the axis
    n_space = (mesh.shape.get("space", 1)
               if shard_space and mesh is not None else 1)
    rng = np.random.default_rng(cfg.seed)
    h, w = content_hw
    contents = [rng.random((h, w, 3), dtype=np.float32)
                for _ in range(batch)]
    style = rng.random((h, w, 3), dtype=np.float32)
    inits = [resize_to_level(c, cfg.levels_num - 1, cfg.base_diameter)
             for c in contents]
    job = BatchedTransferJob(
        contents[:lanes], [style] * lanes, cfg, device=dev,
        init_overrides=inits[:lanes],
        mesh=row_mesh(mesh, 0) if n_space > 1 else None,
        shard_space=n_space > 1)
    opt_cls = _Adam if cfg.optimizer == "adam" else _Lbfgs
    weights = [_nbytes(w) for w in _weights(job)]
    targets = [0] * len(weights)
    for content, grams in job.targets:
        for k, t in enumerate(_blocks(content)):
            targets[k] += _nbytes([t])
        targets[0] += _nbytes(grams)
    state = _state_bytes(job, opt_cls, lanes)
    argument = [sum(v) for v in zip(weights, targets, state)]

    if lanes <= 2:
        saved, peak = _count_blocks(job, lanes)
    else:
        one, two = _count_blocks(job, 1), _count_blocks(job, 2)
        saved, peak = ([a + (lanes - 1) * (b - a) for a, b in zip(u, v)]
                       for u, v in zip(one, two))
    shards = [dict(argument_bytes=a, saved_activation_bytes=s,
                   recompute_peak_bytes=p, predicted_bytes=a + s + p,
                   state_bytes=st)
              for a, s, p, st in zip(argument, saved, peak, state)]
    out = dict(max(shards, key=lambda d: d["predicted_bytes"]))
    if mesh is not None:
        out.update(jobs_axis=axis, lanes_per_card=lanes)
    if job.space:
        out.update(space_axis=len(job.space), per_shard=[
            dict(device=str(d), weight_bytes=w, target_bytes=t, **sh)
            for d, w, t, sh in zip(job.space, weights, targets, shards)])
    if dev.type != "cuda":
        return out

    out["peak_bytes"] = None
    if limit_bytes is not None and out["predicted_bytes"] > limit_bytes:
        return out
    if axis > 1:
        del job
        sharded = BatchedTransferJob(contents, [style] * batch, cfg,
                                     mesh=mesh, shard_space=shard_space,
                                     init_overrides=inits)
        out["per_card"] = [
            dict(device=str(d), **m) for d, m in zip(
                sharded._devices, run_on_shards(
                    sharded._devices,
                    [partial(_measure, shard) for shard in sharded.shards]))]
        if sharded.space:
            out["per_card"] = [dict(device=d, **m)
                               for card in out["per_card"]
                               for d, m in card["cards"].items()]
        out["peak_bytes"] = max(c["peak_bytes"] for c in out["per_card"])
        return out
    measured = _measure(job)
    if job.space:
        out["per_card"] = [dict(device=d, **m)
                           for d, m in measured["cards"].items()]
        out["peak_bytes"] = max(c["peak_bytes"] for c in out["per_card"])
    else:
        out.update(measured)
    return out


def _measure(job) -> dict:
    """The peak allocated on job's card over one captured evaluation and
    one optimizer step of its lanes, and what was allocated before; for a
    space row, those of each of its distinct cards under "cards"."""
    cards = list(dict.fromkeys(job.space or (job.device,)))
    drop_graph(job, job.batch)  # so that the evaluation below captures
    before = {}
    for dev in cards:
        torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    for dev in cards:
        before[dev] = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    x = job._x0.clone()
    opt = job.init_opt(x)
    with precision_gate(job.cfg.conv_precision):
        opt.step(x, 0)
    per = {}
    for dev in cards:
        torch.cuda.synchronize(dev)
        per[str(dev)] = {"allocated_before_bytes": before[dev],
                         "peak_bytes": torch.cuda.max_memory_allocated(dev)}
    del opt
    drop_graph(job, job.batch)
    if job.space:
        return {"cards": per}
    return per[str(job.device)]
