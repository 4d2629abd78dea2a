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
"""

from __future__ import annotations

from functools import partial
from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from ..config import Config, precision_gate
from ..engine.pyramid import resize_to_level
from ..engine.transfer import _Adam, _Lbfgs, drop_graph, level_pass
from ..ops.resize import downscale2x
from .batch import BatchedTransferJob, _select_targets
from .mesh import check_mesh, jobs_axis, placement
from .shards import run_on_shards


def _nbytes(tensors: Iterable[torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _argument_tensors(job):
    """The weights, targets and initial images of a batch."""
    yield from (t for layer in job.params.values() for t in layer.values())
    for content, grams in job.targets:
        yield content
        yield from grams
    yield job._x0


def _saved_bytes(fn, exclude) -> int:
    """Bytes of the storages autograd saves while fn() runs, each storage
    once, those in `exclude` (data pointers) left out. fn's graph is
    never run backward: the hook keeps each saved storage alive until the
    count is done (so no freed storage's address is reused meanwhile) and
    gives autograd nothing back, since a saved output handed back to its
    own node would make a reference cycle that is never freed."""
    kept = {}

    def pack(t):
        storage = t.untyped_storage()
        if storage.data_ptr() not in exclude:
            kept[storage.data_ptr()] = storage

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda _: None):
        fn()
    return sum(st.nbytes() for st in kept.values())


def _count(job, lanes: int) -> Tuple[int, int]:
    """(saved_activation_bytes, recompute_peak_bytes) of one evaluation
    of the first `lanes` lanes of `job`."""
    cfg = job.cfg
    idx = torch.arange(lanes, device=job.device)
    targets = _select_targets(job.targets, idx)
    x = job._x0[:lanes].clone().requires_grad_(True)
    exclude = {t.untyped_storage().data_ptr()
               for t in (*_argument_tensors(job), x)}
    exclude |= {t.untyped_storage().data_ptr() for content, grams in targets
                for t in (content, *grams)}
    with precision_gate(cfg.conv_precision):
        saved = _saved_bytes(
            lambda: job._loss_fn(job.params, targets, x), exclude)
        if not cfg.remat_levels:
            return saved, 0
        # each level's pass as its recomputation runs it, its input image
        # (held by the checkpoint, counted above) left out
        peak = 0
        with torch.no_grad():
            cur = x.detach().reshape((lanes,) + job.level_shapes[0][1:])
        for lvl in range(len(job.level_shapes)):
            if lvl > 0:
                with torch.no_grad():
                    cur = downscale2x(cur)
            img = cur.detach().requires_grad_(True)
            peak = max(peak, _saved_bytes(
                lambda: level_pass(job.params, targets, lvl, img, cfg),
                exclude | {img.untyped_storage().data_ptr()}))
        return saved, peak


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
    module docstring). shard_space raises NotImplementedError, as in
    BatchedTransferJob."""
    check_mesh(mesh, shard_space)
    dev = placement(mesh, device)
    axis = jobs_axis(mesh)
    lanes = -(-batch // axis)  # per card, the batch padded to the axis
    rng = np.random.default_rng(cfg.seed)
    h, w = content_hw
    contents = [rng.random((h, w, 3), dtype=np.float32)
                for _ in range(batch)]
    style = rng.random((h, w, 3), dtype=np.float32)
    inits = [resize_to_level(c, cfg.levels_num - 1, cfg.base_diameter)
             for c in contents]
    job = BatchedTransferJob(contents[:lanes], [style] * lanes, cfg,
                             device=dev, init_overrides=inits[:lanes])
    n = job._x0.shape[1]
    opt_cls = _Adam if cfg.optimizer == "adam" else _Lbfgs
    argument = (_nbytes(_argument_tensors(job))
                + _nbytes(opt_cls.leaf_specs(cfg, lanes, n).values()))

    if lanes <= 2:
        saved, peak = _count(job, lanes)
    else:
        one, two = _count(job, 1), _count(job, 2)
        saved, peak = (a + (lanes - 1) * (b - a) for a, b in zip(one, two))
    out = {"argument_bytes": argument, "saved_activation_bytes": saved,
           "recompute_peak_bytes": peak,
           "predicted_bytes": argument + saved + peak}
    if mesh is not None:
        out.update(jobs_axis=axis, lanes_per_card=lanes)
    if dev.type != "cuda":
        return out

    out["peak_bytes"] = None
    if limit_bytes is not None and out["predicted_bytes"] > limit_bytes:
        return out
    if axis > 1:
        del job
        sharded = BatchedTransferJob(contents, [style] * batch, cfg,
                                     mesh=mesh, init_overrides=inits)
        out["per_card"] = [
            dict(device=str(d), **m) for d, m in zip(
                sharded._devices, run_on_shards(
                    sharded._devices,
                    [partial(_measure, shard) for shard in sharded.shards]))]
        out["peak_bytes"] = max(c["peak_bytes"] for c in out["per_card"])
        return out
    out.update(_measure(job))
    return out


def _measure(job) -> dict:
    """The peak allocated on job's card over one captured evaluation and
    one optimizer step of its lanes, and what was allocated before."""
    dev = job.device
    drop_graph(job, job.batch)  # so that the evaluation below captures
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    x = job._x0.clone()
    opt = job.init_opt(x)
    with precision_gate(job.cfg.conv_precision):
        opt.step(x, 0)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    del opt
    drop_graph(job, job.batch)
    return {"allocated_before_bytes": before, "peak_bytes": peak}
