"""The style-transfer engine: pyramid-loss optimization in PyTorch.

Reference behavior (reference neural_style_transfer.py):
- one loss per pyramid level with precomputed targets (:141-147, :78-82)
- per step: build the optimizing-image pyramid by repeated bicubic /2
  downscale, accumulate per-level totals, backprop, optimizer step with
  lr *= 0.999 per iteration (:152-206)
- an async generator yielding (percent, image_float_rgb_hwc) (:229-372)

A port of the JAX package's ``engine/transfer.py``. PyTorch runs eagerly,
so a step is a host loop over device work: the VGG passes, the losses
(Gram and TV through the hand-written kernels on the card), autograd, and
the Adam or strong-Wolfe L-BFGS update. The optimization vector is the
flattened NHWC top-level image, in the JAX package's order
(``prepare_img(...).reshape(-1)``), so states and goldens compare
directly.

The loss graph, the targets and Adam take a leading lane axis as they
are: B jobs of one shape stack their images as (B, n) and their targets
as (B, ...), every loss is a (B,) vector, and a lane's gradient is that of
its own loss, since VGG couples no lanes. A single job is one lane, and
parallel/batch.py builds the batched job on the same pieces. A space
row's lanes (parallel/space.py: each lane's rows over several devices)
run the same levels over row blocks (``_make_space_pyramid_loss``), and
Adam and L-BFGS take their SpaceLanes as they are.

On CUDA every loss-and-gradient evaluation replays a CUDA graph captured
once per (bucket shape, lanes, config, weights) and kept in the bounded
``_COMPILE_CACHE`` (engine/graphs.py; the JAX package's jitted runners):
one host launch instead of ~370 kernel launches. ``graphs=False`` runs
eagerly, as the CPU does by default. The optimizers' updates and the
per-level metrics stay eager.

``TransferJob.run`` checkpoints and resumes the whole optimization state
(engine/checkpoint.py), as the JAX package's does.

``cfg.remat_levels`` checkpoints each pyramid level's feature-and-loss
pass (``torch.utils.checkpoint``, non-reentrant; the JAX package's
``jax.checkpoint``): the forward keeps only each level's input image, and
the backward recomputes one level's activations at a time, so the Gram
and TV forward kernels run twice per evaluation. The results are the same
bits.

``cfg.pipeline_streaming`` (lookahead) issues chunk k's device->host
copy of the image and loss, then dispatches chunk k+1, and only then
waits for the copy and yields chunk k: the copy, ``unprepare_img`` and the
consumer's work overlap the next chunk on the card. Same values, same
order as the sequential path. The port applies it to Adam, whose steps
the host queues ahead of the card; the host-driven L-BFGS streams
sequentially (``async_steps``).
"""

from __future__ import annotations

import asyncio
import os
import sys
import threading
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..config import Config, held_precision, precision_gate, resolve_device
from ..models.vgg19 import (CONTENT_INDEX, STYLE_INDICES, extract_features,
                            extract_features_blocks)
from ..models.weights import shared_params
from ..ops.gram import gram_matrix
from ..ops.losses import level_loss, space_level_loss
from ..ops.blocks import fan_out
from ..ops.resize import downscale2x, downscale2x_blocks
from ..utils.cache import BoundedCache
from ..utils.image import prepare_img, unprepare_img
from ..utils.metrics import span
from . import checkpoint as ckpt
from . import graphs as graphs_mod
from . import lbfgs as lbfgs_mod
from .init_pipeline import build_init_image
from .pyramid import build_input_pyramids


class ContentStylePair:
    """Pairs content image - style image (reference neural_style_transfer.py:32-36)."""

    def __init__(self, content, style):
        self.content = content  # (content_img_name, content_img)
        self.style = style      # (style_img_name, style_img)


def _raise_nonfinite(f: float, done: int, cfg: Config) -> None:
    raise FloatingPointError(
        f"non-finite loss {f} at step {done} (optimizer={cfg.optimizer}, "
        f"lr_start={cfg.lr_start}); the reference's autograd-anomaly "
        f"guard analogue tripped")


def _raise_nonfinite_batch(bad, done, real_batch, cfg: Config) -> None:
    """One message for every batched non-finite-loss guard site."""
    raise FloatingPointError(
        f"non-finite loss at step {done} for batch element(s) {bad} of "
        f"{real_batch} (optimizer={cfg.optimizer}, "
        f"lr_start={cfg.lr_start})")


# The JAX package's budget for the L-BFGS s/y history of a job or a batch
# (half a 16 GB TPU chip), not yet measured on the card: above it a job
# warns and a queue splits its groups (parallel/batch.py).
LBFGS_HISTORY_BUDGET_GB = 8.0


def lbfgs_history_gb(cfg: Config, level_shapes, batch: int = 1,
                     space: int = 1) -> float:
    """Device memory the L-BFGS s/y history buffers of `batch` jobs need
    on each card, in GB: the history rows shard with the pixels over a
    space row of `space` cards (parallel/space.py); bfloat16 storage
    (cfg.lbfgs_state_dtype) halves it."""
    n_pixels = int(np.prod(level_shapes[0]))
    bytes_per = 2 if cfg.lbfgs_state_dtype == "bfloat16" else 4
    return (2 * cfg.lbfgs_history * n_pixels * bytes_per * batch
            / space / 1e9)


def warn_lbfgs_hbm(cfg: Config, level_shapes, batch: int = 1,
                   space: int = 1) -> bool:
    """Print a stderr warning when the (batched, space-sharded) L-BFGS
    history of a card exceeds LBFGS_HISTORY_BUDGET_GB; returns whether it
    fired. One formula and threshold for the single-job and batched
    sites."""
    hist_gb = lbfgs_history_gb(cfg, level_shapes, batch, space)
    if hist_gb <= LBFGS_HISTORY_BUDGET_GB:
        return False
    jobs = f"{batch} jobs x " if batch > 1 else ""
    shard = f" a card over {space} cards" if space > 1 else ""
    dt_hint = ("" if cfg.lbfgs_state_dtype == "bfloat16"
               else "--lbfgs-state-dtype bfloat16 (halves it), ")
    print(f"warning: L-BFGS history buffers need ~{hist_gb:.1f} GB of device "
          f"memory{shard} ({jobs}history={cfg.lbfgs_history}); consider "
          f"{dt_hint}--lbfgs-history 10, sharding the pixels over more "
          f"cards (queue_cli --space N), or a smaller batch/resolution",
          file=sys.stderr)
    return True


def _config_key(cfg: Config, level_shapes) -> tuple:
    """The engine config's fingerprint, stored in and checked against a
    checkpoint: every field that changes the numerics of a step (the JAX
    package's _config_key without its TPU-only fields: pool_impl,
    use_pallas and the space mesh, which no port path reads)."""
    return (tuple(level_shapes), cfg.content_weight, cfg.style_weight,
            cfg.tv_weight, cfg.optimizer, cfg.compute_dtype,
            cfg.conv_precision, cfg.use_relu,
            cfg.stream_every, cfg.lr_start, cfg.lr_decay,
            cfg.lr_decay_per_eval,
            cfg.lbfgs_history, cfg.lbfgs_max_ls_steps, cfg.lbfgs_direction,
            cfg.lbfgs_t_init, cfg.lbfgs_grams, cfg.lbfgs_state_dtype,
            cfg.remat_levels, cfg.fused_style_bwd)


def _check_supported(cfg: Config) -> None:
    if cfg.model != "vgg19":
        raise ValueError(f"{cfg.model} not supported.")
    if cfg.optimizer not in ("adam", "lbfgs"):
        raise RuntimeError("Unknown optimizer")  # reference parity (:138)
    if cfg.optimizer == "lbfgs":
        if cfg.lbfgs_grams not in ("recompute", "incremental"):
            raise ValueError(f"unknown lbfgs_grams {cfg.lbfgs_grams!r}; "
                             "expected 'recompute' or 'incremental'")
        if cfg.lbfgs_state_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"unknown lbfgs_state_dtype {cfg.lbfgs_state_dtype!r}; "
                "expected 'float32' or 'bfloat16'")


# --------------------------------------------------------------------------
# Loss graph
# --------------------------------------------------------------------------


def level_pass(params, targets, lvl: int, cur: torch.Tensor,
               cfg: Config):
    """One pyramid level's feature-and-loss pass: VGG19 on the level's
    (B, h, w, 3) image and its LevelLoss against targets[lvl]."""
    feats = extract_features(params, cur, cfg.compute_dtype,
                             use_relu=cfg.use_relu)
    t_content, t_grams = targets[lvl]
    return level_loss(feats, t_content, t_grams, cur,
                      cfg.content_weight, cfg.style_weight,
                      cfg.tv_weight, CONTENT_INDEX, STYLE_INDICES,
                      use_pallas=cfg.use_pallas,
                      fused_style_bwd=cfg.fused_style_bwd)


def _make_pyramid_loss(level_shapes: List[Tuple[int, int, int, int]],
                       cfg: Config):
    """Returns loss_fn(params, targets, x) -> ((B,) totals, LevelLoss list).

    targets: tuple per level of (content_tap, tuple(grams)), each with the
    lane axis (B, ...).
    x: the (B, n) flattened top-level preprocessed images (NHWC order), or
    one (n,) image (B = 1).

    With cfg.remat_levels (and grad enabled) each level's pass runs under
    non-reentrant torch.utils.checkpoint. It draws no random numbers, so
    the RNG state is not saved: reading the CUDA generator is not allowed
    inside a graph capture.
    """
    lane_shape = tuple(level_shapes[0][1:])

    def loss_fn(params, targets, x):
        cur = x.reshape((-1,) + lane_shape)
        total = 0.0
        metrics = []
        for lvl in range(len(level_shapes)):
            if lvl > 0:
                cur = downscale2x(cur)

            def one_level(cur, lvl=lvl):
                return level_pass(params, targets, lvl, cur, cfg)

            if cfg.remat_levels and torch.is_grad_enabled():
                ll = checkpoint(one_level, cur, use_reentrant=False,
                                preserve_rng_state=False)
            else:
                ll = one_level(cur)
            # level totals accumulate (previous_loss_importance = 1.0,
            # reference neural_style_transfer.py:180-186)
            total = total + ll.total
            metrics.append(ll)
        return total, metrics

    return loss_fn


def space_level_pass(params, targets, lvl: int, blocks, cfg: Config):
    """level_pass over the row blocks of one level's (B, h, w, 3) image,
    block k on the space row's k-th device with params[k] (its copy of
    the weights): VGG19 with a halo at every conv, and the level's losses
    summed over the blocks on the first device (ops/losses.py
    space_level_loss)."""
    blocks, tv_blocks = fan_out(blocks, 2)
    feats = extract_features_blocks(params, blocks, cfg.compute_dtype,
                                    use_relu=cfg.use_relu)
    t_content, t_grams = targets[lvl]
    return space_level_loss(feats, t_content, t_grams, tv_blocks,
                            cfg.content_weight, cfg.style_weight,
                            cfg.tv_weight, CONTENT_INDEX, STYLE_INDICES,
                            use_pallas=cfg.use_pallas,
                            fused_style_bwd=cfg.fused_style_bwd)


def _make_space_pyramid_loss(level_shapes: List[Tuple[int, int, int, int]],
                             cfg: Config):
    """_make_pyramid_loss over a space row (parallel/space.py): x is a
    SpaceLanes of the (B, n) images, block k holding rows [k h / S,
    (k+1) h / S) of the top level, and params the per-device weights.
    Each level's blocks come from the level above by the block form of
    the bicubic downscale; the totals and the metrics are on the row's
    first device. targets: per level (the flattened content tap as a
    SpaceLanes of the same rows, the Grams on the first device)."""
    lane_shape = tuple(level_shapes[0][1:])

    def loss_fn(params, targets, x):
        n = len(x.blocks)
        blocks = [b.reshape((-1, lane_shape[0] // n) + lane_shape[1:])
                  for b in x.blocks]
        total = 0.0
        metrics = []
        for lvl in range(len(level_shapes)):
            if lvl > 0:
                blocks = downscale2x_blocks(below)
            if lvl + 1 < len(level_shapes):
                blocks, below = fan_out(blocks, 2)

            def one_level(*blocks, lvl=lvl):
                return space_level_pass(params, targets, lvl, list(blocks),
                                        cfg)

            if cfg.remat_levels and torch.is_grad_enabled():
                ll = checkpoint(one_level, *blocks, use_reentrant=False,
                                preserve_rng_state=False)
            else:
                ll = one_level(*blocks)
            total = total + ll.total
            metrics.append(ll)
        return total, metrics

    return loss_fn


@torch.no_grad()
def _compute_targets(params, content_levels_pre: List[torch.Tensor],
                     style_levels_pre: List[torch.Tensor], cfg: Config):
    """Per-level target content tap + style Grams, float32 (reference
    neural_style_transfer.py:78-82). Each level's content and style images
    are (B, h, w, 3) stacks, one job per lane; the targets keep that lane
    axis."""
    targets = []
    for c_img, s_img in zip(content_levels_pre, style_levels_pre):
        c_feats = extract_features(params, c_img, cfg.compute_dtype,
                                   use_relu=cfg.use_relu)
        s_feats = extract_features(params, s_img, cfg.compute_dtype,
                                   use_relu=cfg.use_relu)
        t_content = c_feats[CONTENT_INDEX].float().contiguous()
        t_grams = tuple(gram_matrix(s_feats[i]) for i in STYLE_INDICES)
        targets.append((t_content, t_grams))
    return tuple(targets)


# --------------------------------------------------------------------------
# Captured evaluations (cached per shape + config + lanes + weights)
# --------------------------------------------------------------------------

# LRU-bounded (ASTT_RUNNER_CACHE_SIZE, default 32), as the JAX package's
# runner cache: each entry holds a CUDA graph and its static buffers
_COMPILE_CACHE = BoundedCache()
_cache_lock = threading.Lock()


def _eval_body(loss_fn, params):
    """body(targets, x) -> ((B,) total losses, (B, n) d total / d x), both
    detached: one eager evaluation, or what a graph captures."""

    # imported here: parallel/ imports this module
    from ..parallel.space import SpaceLanes

    def body(targets, x):
        if isinstance(x, SpaceLanes):
            # one graph over the row's devices; autograd's device threads
            # run each card's part of the backward
            xs = [b.detach().requires_grad_(True) for b in x.blocks]
            total, _ = loss_fn(params, targets, SpaceLanes(xs))
            return total.detach(), SpaceLanes(
                torch.autograd.grad(total.sum(), xs))
        x = x.detach().requires_grad_(True)
        total, _ = loss_fn(params, targets, x)
        (g,) = torch.autograd.grad(total.sum(), x)
        return total.detach(), g

    return body


def graph_key(job, lanes: int) -> tuple:
    """The _COMPILE_CACHE key of `job`'s evaluation at `lanes` lanes: the
    engine config's fingerprint (_config_key, also the checkpoints' own)
    extended by the lanes, the device and the identity of the weights the
    graph binds."""
    return _config_key(job.cfg, job.level_shapes) + (
        lanes, str(job.device), id(job.params))


def drop_graph(job, lanes: int) -> None:
    """Remove `job`'s evaluation at `lanes` lanes from _COMPILE_CACHE (a
    job that holds it keeps using it)."""
    with _cache_lock:
        _COMPILE_CACHE.pop(graph_key(job, lanes))


def eval_graph(job, targets, x: torch.Tensor) -> graphs_mod.EvalGraph:
    """The cached evaluation of `job`'s shapes and config at x's lane
    count (graph_key), captured now if missing (inside the caller's
    precision gate): a CUDA graph on the card, the eager test seam on the
    CPU. cuDNN picks its algorithms when the graph is captured, so a
    capture on the card raises unless the calling thread holds
    precision_gate at the job's conv_precision."""
    key = graph_key(job, x.shape[0])
    with _cache_lock:
        if key in _COMPILE_CACHE:
            return _COMPILE_CACHE[key]
        if (job.device.type == "cuda"
                and held_precision() != job.cfg.conv_precision):
            raise RuntimeError(
                f"a {job.cfg.conv_precision!r} evaluation captured outside "
                "precision_gate would keep the cuDNN algorithms of whatever "
                "settings were current")
        capture = (graphs_mod.cuda_capture if job.device.type == "cuda"
                   else graphs_mod.eager_capture)
        with span("graph.capture", lanes=x.shape[0]):
            entry = graphs_mod.EvalGraph(
                _eval_body(job._loss_fn, job.params), x, targets, capture)
        _COMPILE_CACHE[key] = entry
        return entry


class LossGrad:
    """loss_grad(x) for a job's (B, n) lanes against `targets`: ((B,)
    losses, (B, n) gradient), tensors the caller owns. Graphed: a replay
    of the job's cached evaluation for B lanes, bound to these targets;
    else eager. along(x, t, d) evaluates at x + t d (L-BFGS's trial
    points; graphed, the point is written straight into the static
    input)."""

    def __init__(self, job, targets, graphed: bool):
        self._job = job
        self._targets = targets
        self._graphed = graphed
        self._graph = None
        self._owner = object()  # binds the entry without keeping the job

    def _entry(self, x):
        if self._graph is None:
            self._graph = eval_graph(self._job, self._targets, x)
        return self._graph

    def __call__(self, x: torch.Tensor):
        with span("engine.eval", lanes=x.shape[0]):
            if not self._graphed:
                return _eval_body(self._job._loss_fn, self._job.params)(
                    self._targets, x)
            return self._entry(x)(self._owner, self._targets, x)

    def along(self, x: torch.Tensor, t: torch.Tensor, d: torch.Tensor):
        if not self._graphed:
            return self(x.addcmul(t, d))
        with span("engine.eval", lanes=x.shape[0]):
            return self._entry(x)(self._owner, self._targets, x, t, d)


def use_graphs(device: torch.device, graphs: Optional[bool]) -> bool:
    """A job's graphs setting: on for CUDA unless graphs=False; off on the
    CPU unless graphs=True (the eager-replay test seam)."""
    return device.type == "cuda" if graphs is None else bool(graphs)


def _lr_at(cfg: Config, step: int) -> np.float32:
    """lr before the (0-based) step's update: the reference decays BEFORE
    each use, so step k runs at lr_start * decay^(k+1) (float32)."""
    return np.float32(cfg.lr_start * np.power(np.float32(cfg.lr_decay),
                                              np.float32(step + 1.0)))


def _lr_per_eval(cfg: Config, n_evals: int, step: int) -> np.float32:
    """lr of a step under the reference's per-evaluation decay: the
    reference's closure decays lr on EVERY invocation and torch's
    strong-Wolfe calls it (1 top call + ls evals) times per step;
    init_state's eval stands in for step 1's top call, so the exponent is
    step + (n_evals - 1)."""
    expo = np.float32(n_evals) + np.float32(step) - np.float32(1.0)
    return np.float32(cfg.lr_start * np.power(np.float32(cfg.lr_decay), expo))


def _host_steps(leaf: torch.Tensor):
    """A step-counter leaf on the host: an int (0-d, shared by the lanes)
    or a (B,) int64 array (one count per lane)."""
    return (int(leaf) if leaf.dim() == 0
            else leaf.cpu().numpy().astype(np.int64))


def _per_lane(values, fn, device):
    """fn of each lane's value (values an int or a (B,) array): a Python
    float when every lane holds the same value (the scalar path, whose
    bits the batched queue and the goldens pin), else a (B, 1) float32
    tensor on `device`."""
    v = np.asarray(values)
    if (v == v.flat[0]).all():
        return float(fn(int(v.flat[0])))
    return torch.tensor(np.array([fn(int(e)) for e in v.ravel()], np.float32),
                        device=device).unsqueeze(1)


def _zeros_like(x):
    """Zeros of x's shape and layout (a plain tensor or a SpaceLanes)."""
    return torch.zeros_like(x) if isinstance(x, torch.Tensor) else x.zeros_like()


class _Adam:
    """optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8) then x -= lr * update
    (torch Adam's defaults, reference neural_style_transfer.py:134).
    Elementwise, so it serves a (B, n) stack of lanes as it is: per-lane
    moments, and a bias-correction count that is an int while the lanes
    step together (the JAX package's vmapped ``batched_chunk``) or a (B,)
    array in a live batch whose lanes joined at different steps
    (``batched_chunk_steps``). leaves: a checkpoint's state (leaf_specs's
    names), or a live transplant's, to continue from instead of zeros."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, loss_grad, x: torch.Tensor, cfg: Config,
                 leaves: Optional[Dict[str, torch.Tensor]] = None):
        self.loss_grad = loss_grad
        self.cfg = cfg
        if leaves is None:
            self.mu = _zeros_like(x)
            self.nu = _zeros_like(x)
            self.count = 0
        else:
            self.mu = lbfgs_mod._like(leaves["mu"], x)
            self.nu = lbfgs_mod._like(leaves["nu"], x)
            self.count = _host_steps(leaves["count"])

    @staticmethod
    def leaf_specs(cfg: Config, b: int, n: int) -> Dict[str, torch.Tensor]:
        """{leaf name: meta tensor} of the state of b lanes of n values."""
        return {"mu": torch.empty((b, n), device="meta"),
                "nu": torch.empty((b, n), device="meta"),
                "count": torch.empty((), dtype=torch.int64, device="meta")}

    def leaves(self) -> Dict[str, torch.Tensor]:
        return {"mu": self.mu, "nu": self.nu,
                "count": torch.tensor(self.count, dtype=torch.int64)}

    def step(self, x: torch.Tensor, step):
        """One update of every lane; step is the 0-based step of all lanes
        (an int) or of each lane (a (B,) array)."""
        f, g = self.loss_grad(x)
        b1, b2 = self.b1, self.b2
        self.mu = (1 - b1) * g + b1 * self.mu
        self.nu = (1 - b2) * (g * g) + b2 * self.nu
        self.count = self.count + 1
        bc1 = _per_lane(self.count, lambda c: np.float32(1.0)
                        - np.float32(b1) ** np.float32(c), x.device)
        bc2 = _per_lane(self.count, lambda c: np.float32(1.0)
                        - np.float32(b2) ** np.float32(c), x.device)
        lr = _per_lane(step, lambda s: _lr_at(self.cfg, s), x.device)
        update = (self.mu / bc1) / ((self.nu / bc2).sqrt() + self.eps)
        return x - lr * update, f

    def select(self, lanes) -> None:
        """Keep (and repeat) the given lanes of the moments, in place."""
        idx = torch.as_tensor(np.asarray(lanes), dtype=torch.long,
                              device=self.mu.device)
        self.mu = self.mu.index_select(0, idx)
        self.nu = self.nu.index_select(0, idx)
        if isinstance(self.count, np.ndarray):
            self.count = self.count[lanes]


class _Lbfgs:
    """engine/lbfgs.py over a (B, n) stack of lanes, with the reference's
    per-evaluation lr decay: each lane keeps its own history, evaluation
    count and lr schedule (a single job is one lane). step returns the
    (B,) losses as a float32 tensor on x's device. leaves: a checkpoint's
    state (leaf_specs's names) to continue from, with no evaluation."""

    def __init__(self, loss_grad, x: torch.Tensor, cfg: Config,
                 leaves: Optional[Dict[str, torch.Tensor]] = None):
        self.loss_grad = loss_grad
        self.cfg = cfg
        if leaves is None:
            self.state = lbfgs_mod.lane_init_state(
                loss_grad, x, cfg.lbfgs_history,
                track_grams=self._track_grams(cfg),
                state_dtype=cfg.lbfgs_state_dtype)
        else:
            self.state = lbfgs_mod.state_from_leaves(leaves, x)

    @staticmethod
    def _track_grams(cfg: Config) -> bool:
        # the carried Grams serve the matrix direction only
        return (cfg.lbfgs_grams == "incremental"
                and cfg.lbfgs_direction == "matrix")

    @classmethod
    def leaf_specs(cls, cfg: Config, b: int, n: int) -> Dict[str, torch.Tensor]:
        """{leaf name: meta tensor} of the state of b lanes of n values."""
        return lbfgs_mod.lane_state_specs(b, n, cfg.lbfgs_history,
                                          cls._track_grams(cfg),
                                          cfg.lbfgs_state_dtype)

    def leaves(self) -> Dict[str, torch.Tensor]:
        return lbfgs_mod.state_leaves(self.state)

    def step(self, x: torch.Tensor, step):
        """One L-BFGS iteration of every lane; step as _Adam.step's."""
        cfg = self.cfg
        steps = np.broadcast_to(np.asarray(step), (x.shape[0],))
        if cfg.lr_decay_per_eval:
            lr = np.array([_lr_per_eval(cfg, n, int(s))
                           for n, s in zip(self.state.n_evals, steps)],
                          np.float32)
        else:
            lr = np.array([_lr_at(cfg, int(s)) for s in steps], np.float32)
        x, self.state = lbfgs_mod.lane_lbfgs_step(
            self.loss_grad, x, self.state, lr,
            max_ls_steps=cfg.lbfgs_max_ls_steps,
            direction_impl=cfg.lbfgs_direction, t_init=cfg.lbfgs_t_init)
        return x, torch.from_numpy(self.state.f.copy()).to(x.device)

    def select(self, lanes) -> None:
        self.state.select(lanes)


def async_steps(cfg: Config) -> bool:
    """Whether lookahead streaming applies to cfg's steps: with
    cfg.pipeline_streaming, for Adam, whose steps the host queues without
    reading the device. An L-BFGS step reads the device in every round of
    its line search, so dispatching the next chunk takes as long as
    running it: under lookahead each progress image would come a chunk
    late, to save one device->host copy and unprepare_img per chunk
    (measured on an H100: PERF.md §6)."""
    return cfg.pipeline_streaming and cfg.optimizer == "adam"


def _pieces(t):
    """(the device tensors t is made of, a function that joins their host
    copies into t's host tensor): a tensor is itself, a sharded batch's
    Lanes its parts in lane order, a space row's SpaceLanes its blocks in
    pixel order (the two nest)."""
    # imported here: parallel/ imports this module
    from ..parallel.space import SpaceLanes

    if isinstance(t, torch.Tensor):
        return [t], lambda host: host[0]
    parts, dim = ((t.blocks, -1) if isinstance(t, SpaceLanes)
                  else (t.parts, 0))
    subs = [_pieces(p) for p in parts]

    def join(host):
        out, i = [], 0
        for got, sub_join in subs:
            out.append(sub_join(host[i:i + len(got)]))
            i += len(got)
        return out[0] if len(out) == 1 else torch.cat(out, dim=dim)

    return [p for got, _j in subs for p in got], join


class HostCopies:
    """Lookahead streaming (cfg.pipeline_streaming): each chunk's results
    on their way to the host while the next chunk runs.

    copy(*tensors) starts copying a chunk's results to the host and
    returns fetch(), which waits for that copy and returns the host
    tensors. On CUDA the copies go into the next of two sets of pinned
    buffers, used in turn (one set is still being read while the next
    fills), with non_blocking=True, and an event is recorded after them
    on each device: issued before the next chunk is dispatched, the copy
    waits for nothing queued after it, which a blocking .cpu() issued
    later would. On the CPU the tensors are cloned. A fetched set is
    valid until the second copy() after it. A sharded batch's Lanes
    (parallel/shards.py) is copied piece by piece and fetched whole."""

    def __init__(self):
        self._sets: List[Optional[List[torch.Tensor]]] = [None, None]
        self._turn = 0
        self._pending = None  # (done, fetch) of the chunk not yet yielded

    def after_chunk(self, done, x, f, last: bool, materialize):
        """Yields what lookahead streams once a chunk is dispatched: the
        chunk before it, materialize(done, x, f)'d from its copy, and the
        last chunk itself, which needs no copy (nothing runs after it).
        This chunk's copy is issued first."""
        ahead = None if last else (done, self.copy(x, f))
        pending, self._pending = self._pending, ahead
        if pending is not None:
            yield materialize(pending[0], *pending[1]())
        if last:
            yield materialize(done, x, f)

    def copy(self, *tensors):
        pieces = [_pieces(t) for t in tensors]
        flat = [p for got, _join in pieces for p in got]

        def regroup(host):
            out, i = [], 0
            for got, join in pieces:
                out.append(join(host[i:i + len(got)]))
                i += len(got)
            return out

        if not flat[0].is_cuda:
            host = regroup([t.detach().clone() for t in flat])
            return lambda: host
        bufs = self._sets[self._turn]
        if bufs is None or [b.shape for b in bufs] != [t.shape
                                                       for t in flat]:
            bufs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    for t in flat]
            self._sets[self._turn] = bufs
        self._turn ^= 1
        for b, t in zip(bufs, flat):
            b.copy_(t.detach(), non_blocking=True)
        events = []
        for dev in dict.fromkeys(t.device for t in flat):
            events.append(torch.cuda.Event())
            events[-1].record(torch.cuda.current_stream(dev))

        def fetch():
            with span("engine.fetch"):
                for copied in events:
                    copied.synchronize()
            return regroup(bufs)

        return fetch


# --------------------------------------------------------------------------
# Job API
# --------------------------------------------------------------------------


class TransferJob:
    """A style-transfer job for one content/style pair.

    Runs on CUDA unless device='cpu' is passed; raises when CUDA is
    unavailable and the CPU was not asked for. params: repo-format numpy
    weights (HWIO, as load_vgg19_params / init_vgg19_params return them);
    None resolves them from cfg.seed. graphs: evaluate by CUDA graph
    replay (the default on CUDA; graphs=False runs eagerly, the
    counterpart of jax.disable_jit; on the CPU graphs=True runs the
    graphs' static-buffer plumbing eagerly, for tests).
    """

    def __init__(self, content: np.ndarray, style: np.ndarray, cfg: Config,
                 params=None, init_override: Optional[np.ndarray] = None,
                 device=None, graphs: Optional[bool] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        _check_supported(cfg)
        self.params = shared_params(params, cfg.seed, self.device)

        content_levels, style_levels = build_input_pyramids(
            content, style, cfg.levels_num, cfg.base_diameter)
        self.level_shapes = [tuple(prepare_img(c).shape)
                             for c in content_levels]
        if cfg.optimizer == "lbfgs":
            warn_lbfgs_hbm(cfg, self.level_shapes)

        def on_device(img):
            return torch.from_numpy(prepare_img(img)).to(self.device)

        c_pre = [on_device(c) for c in content_levels]
        s_pre = [on_device(s) for s in style_levels]
        self._loss_fn = _make_pyramid_loss(self.level_shapes, cfg)
        with precision_gate(cfg.conv_precision):
            self.targets = _compute_targets(self.params, c_pre, s_pre, cfg)
        self._loss_grad = LossGrad(self, self.targets,
                                   use_graphs(self.device, graphs))

        self.last_level_losses = None  # set by run(report_level_losses=True)
        if init_override is not None:
            init_img = init_override
            self.init_name = "override"
        else:
            init_img, self.init_name = build_init_image(
                cfg.init_method, content, style, cfg,
                rng=np.random.default_rng(cfg.seed))
        self._x0 = torch.from_numpy(
            prepare_img(init_img).reshape(1, -1)).to(self.device)  # one lane

    # ---- loss evaluation -------------------------------------------------

    @torch.no_grad()
    def _metrics(self, x: torch.Tensor):
        with precision_gate(self.cfg.conv_precision):
            total, per_level = self._loss_fn(self.params, self.targets, x)
        return float(total), [tuple(float(v) for v in (l.total, l.content,
                                                       l.style, l.tv))
                              for l in per_level]

    def _image(self, x: torch.Tensor) -> np.ndarray:
        return unprepare_img(
            x.detach().reshape(self.level_shapes[0]).cpu().numpy())

    # ---- run ---------------------------------------------------------------

    def run(self, iters_num: Optional[int] = None,
            stream_every: Optional[int] = None,
            checkpoint_path: Optional[str] = None,
            checkpoint_every: Optional[int] = None,
            resume: bool = False,
            yield_images: bool = True,
            report_level_losses: bool = False,
            ) -> Iterator[Tuple[int, np.ndarray, float]]:
        """Run the optimization; yields (steps_done, image_hwc_rgb, loss)
        every stream_every steps.

        iters_num counts OPTIMIZER STEPS (use
        config.reference_equivalent_steps for a reference budget). The image
        is un-preprocessed ([0,1]-domain, unclipped).

        checkpoint_path / checkpoint_every save the whole optimization
        state (engine/checkpoint.py) at the first chunk boundary at least
        checkpoint_every steps after the last save, and at the end;
        resume=True continues from checkpoint_path when it exists (bit for
        bit), and a checkpoint of a finished run yields its final image
        once. A checkpoint written under another engine config or shape
        raises ValueError.

        yield_images=False skips the device->host image copy (and the loss
        sync) on intermediate chunks: those yield (done, None, loss as a
        0-d device tensor); the final chunk always carries the image.
        When images are streamed, cfg.pipeline_streaming (default on)
        yields chunk k only after chunk k+1 was dispatched (HostCopies):
        the same values in the same order. It is off under
        report_level_losses and cfg.stop_tol, which read each chunk's
        results before the next one, and for L-BFGS (async_steps); a
        chunk that writes a checkpoint waits for its state.
        report_level_losses=True stores per-level (total, content, style,
        tv) of every synced chunk in self.last_level_losses.
        cfg.stop_tol > 0 ends the run once the relative loss change over a
        chunk is <= stop_tol; its bookkeeping survives a resume.
        """
        cfg = self.cfg
        iters = iters_num if iters_num is not None else cfg.iters_num
        chunk = stream_every if stream_every is not None else cfg.stream_every
        chunk = max(1, min(chunk, iters))
        fp = str(_config_key(cfg, self.level_shapes))
        opt_cls = _Adam if cfg.optimizer == "adam" else _Lbfgs

        x = self._x0.clone()
        leaves, done, ck_extra = None, 0, {}
        if resume and checkpoint_path and os.path.exists(checkpoint_path):
            x_saved, leaves, done, ck_extra = ckpt.load_checkpoint(
                checkpoint_path, opt_cls.leaf_specs(cfg, 1, x.shape[1]),
                fingerprint=fp, with_extra=True)
            x = x_saved.reshape(x.shape).to(self.device)
            if done >= iters or ck_extra.get("converged"):
                # a finished run (by budget or by stop_tol): its final
                # image, and the loss at it
                total, per_level = self._metrics(x)
                if report_level_losses:
                    self.last_level_losses = per_level
                yield done, self._image(x), total
                return
        with precision_gate(cfg.conv_precision):
            opt = opt_cls(self._loss_grad, x, cfg, leaves)
        last_saved = done
        check_stop = cfg.stop_tol > 0.0
        f_prev = ck_extra.get("f_prev")
        lookahead = (yield_images and async_steps(cfg)
                     and not report_level_losses and not check_stop)
        copies = HostCopies()

        def materialize(done_k, x_k, f_k):
            with span("engine.materialize"):
                f_k = float(f_k)
                if cfg.nan_checks and not np.isfinite(f_k):
                    _raise_nonfinite(f_k, done_k, cfg)
                return done_k, self._image(x_k), f_k

        while done < iters:
            with precision_gate(cfg.conv_precision):  # released at the yield
                k = min(chunk, iters - done)
                with span("engine.chunk", steps=k):
                    for i in range(k):
                        x, f = opt.step(x, done + i)
                f = f[0]  # the one lane's loss, as a 0-d tensor
                done += k
                converged = False
                if check_stop:
                    f = float(f)
                    if cfg.nan_checks and not np.isfinite(f):
                        _raise_nonfinite(f, done, cfg)
                    if (f_prev is not None and abs(f_prev - f)
                            <= cfg.stop_tol * max(1.0, abs(f))):
                        converged = True
                    f_prev = f
                sync = not lookahead and (yield_images or done >= iters
                                          or converged)
                img = None
                if sync:
                    f = float(f)
                    if cfg.nan_checks and not np.isfinite(f):
                        _raise_nonfinite(f, done, cfg)
                if (checkpoint_path and checkpoint_every
                        and (done - last_saved >= checkpoint_every
                             or done >= iters or converged)):
                    ckpt.save_checkpoint(
                        checkpoint_path, x[0], opt.leaves(), done,
                        fingerprint=fp,
                        extra=({"f_prev": f_prev, "converged": converged}
                               if check_stop else None))
                    last_saved = done
                if sync:
                    with span("engine.materialize"):
                        img = self._image(x)
                    if report_level_losses:
                        _total, self.last_level_losses = self._metrics(x)
            if lookahead:
                yield from copies.after_chunk(done, x, f, done >= iters,
                                              materialize)
                continue
            yield done, img, f
            if converged:
                return

    def initial_loss(self) -> float:
        """Total loss at the init image (before any optimization)."""
        return self._metrics(self._x0)[0]

    def loss_report(self, image_hwc: np.ndarray):
        """Per-level loss components of a [0,1]-domain image (diagnostics)."""
        x = torch.from_numpy(prepare_img(image_hwc).reshape(-1)).to(self.device)
        return self._metrics(x)


# --------------------------------------------------------------------------
# Reference-parity async generator
# --------------------------------------------------------------------------


async def neural_style_transfer(content_n_style: ContentStylePair,
                                content_weight, style_weight, tv_weight,
                                optimizer, model, init_method,
                                iters_num, levels_num, noise_factor,
                                noise_levels, noise_levels_central_amplitude,
                                noise_levels_peripheral_amplitude,
                                noise_levels_dispersion,
                                params=None, stream_every: int = 10,
                                seed: int = 0, base_diameter: int = 256,
                                config: Optional[Config] = None,
                                stream_images: bool = True,
                                device=None):
    """Async generator yielding (percent, image) — the reference engine API
    (reference neural_style_transfer.py:229-372).

    The job's blocking work runs in the default thread pool so the event
    loop stays responsive. stream_images=False yields (percent, None) on
    intermediate chunks. Runs on CUDA unless device='cpu'.
    """
    cfg = config if config is not None else Config(
        content_weight=content_weight, style_weight=style_weight,
        tv_weight=tv_weight, optimizer=optimizer, model=model,
        init_method=init_method, iters_num=iters_num, levels_num=levels_num,
        noise_factor=noise_factor, noise_levels=tuple(noise_levels),
        noise_levels_central_amplitude=tuple(noise_levels_central_amplitude),
        noise_levels_peripheral_amplitude=tuple(noise_levels_peripheral_amplitude),
        noise_levels_dispersion=tuple(noise_levels_dispersion),
        stream_every=stream_every, seed=seed, base_diameter=base_diameter,
    )
    dev = resolve_device(device)
    loop = asyncio.get_running_loop()

    job = await loop.run_in_executor(
        None, lambda: TransferJob(content_n_style.content[1],
                                  content_n_style.style[1], cfg, params,
                                  device=dev))

    it = job.run(yield_images=stream_images)

    def next_chunk():
        try:
            return next(it)
        except StopIteration:
            return None

    last_percent, last_img = 0.0, None
    while True:
        res = await loop.run_in_executor(None, next_chunk)
        if res is None:
            break
        done, img, _f = res
        percent = done / cfg.iters_num * 100.0
        last_percent, last_img = percent, img
        yield percent, img
    if cfg.stop_tol > 0.0 and last_percent < 100.0 and last_img is not None:
        # an early stop ended the run below the full budget; consumers key
        # completion on percent >= 100, so re-emit the final image at 100%
        yield 100.0, last_img
