"""Capture the serving buckets' evaluations ahead of the first user.

The port of the JAX package's ``engine/warmup.py``. There XLA compiles one
executable per (pyramid shape, config), minutes for a cold compile on a
TPU; here each (bucket shape, lanes, config, weights) gets one captured
CUDA graph (engine/graphs.py), which costs two eager evaluations and a
capture at the first request of its key. Serving frontends canonicalize
incoming images to the standard aspect buckets (parallel/batch.py), so a
warmup that runs one chunk per bucket and batch size leaves the first
user nothing to capture. A live chunk (parallel/live.py) replays the same
(bucket, lanes) graph, so the batched warmup covers live serving too;
``warm_live_chunk`` is called only where the live path engages (the
'batched' policy route; the JAX package calls it for every config). The
port runs one card: a mesh raises, as it does in parallel/batch.py.
"""

from __future__ import annotations

import sys
import time
from typing import Optional, Sequence

import numpy as np

from ..config import Config
from ..parallel.batch import (DEFAULT_ASPECT_BUCKETS, BatchedTransferJob,
                              _not_ported, bucket_content_shape,
                              planned_round_sizes, resolve_batch_policy)
from . import graphs
from .transfer import TransferJob


def warmup_serving(cfg: Config, online: bool,
                   aspects: Optional[Sequence[float]] = None,
                   device=None) -> int:
    """The frontends' shared --warmup entry point: capture every serving
    aspect bucket's evaluation; with online batching, at every batch size
    online rounds dispatch (online_warmup_plan). Returns the number of
    graphs captured. `aspects` narrows the bucket list (tests). Runs on
    CUDA unless device='cpu', the device the frontend serves on."""
    sizes = None
    if online:
        sizes, _mesh = online_warmup_plan(cfg, None)
    kwargs = {} if aspects is None else {"aspects": aspects}
    return warmup_aspect_buckets(cfg, batch_sizes=sizes, device=device,
                                 **kwargs)


def online_warmup_plan(cfg: Config, mesh, batch_policy: str = "auto",
                       max_batch: int = 8):
    """(batch_sizes, mesh) covering exactly the graphs online-batching
    rounds dispatch, mirroring run_job_queue's routing rules: a
    'batched'-routed config captures the padded power-of-two ladder
    {1, 2, ..., max_batch} (and with stop_shrink the shrink ladder, which
    it holds); a 'sequential'-routed config (full-Wolfe L-BFGS) captures
    single-job batches. One card: mesh must be None."""
    _not_ported(mesh, False)
    policy = resolve_batch_policy(cfg, batch_policy)
    if policy != "batched":
        return (1,), None
    # live round sizes are unknown ahead of time: warm the union of the
    # sizes every possible round 1..max_batch dispatches
    shape = (cfg.base_diameter, cfg.base_diameter, 3)
    sizes = sorted({s for n in range(1, max_batch + 1)
                    for s in planned_round_sizes(cfg, shape, n,
                                                 max_batch=max_batch)})
    return tuple(sizes), None


def warmup_aspect_buckets(cfg: Config, params=None,
                          aspects: Sequence[float] = DEFAULT_ASPECT_BUCKETS,
                          verbose: bool = True,
                          steps: Optional[int] = None,
                          batch_sizes: Optional[Sequence[int]] = None,
                          mesh=None, device=None) -> int:
    """Run one chunk of the engine for every aspect bucket on dummy
    images, capturing its evaluation.

    Returns the number of graphs captured (graphs already cached capture
    nothing). The graphs are keyed by shape, config, lanes and weights,
    so later jobs canonicalized to these buckets with the same weights
    (params: the same object, or None for cfg.seed's) reuse them.

    batch_sizes warms BatchedTransferJob at each of those sizes instead
    (one graph per (bucket, size)), plus the smaller sizes its
    convergence shrinking can reach (warm_shrink_graphs; nothing unless
    cfg.stop_tol and cfg.stop_shrink are set) and, for a 'batched'-policy
    config, the evaluation a live chunk replays (warm_live_chunk). Pass
    the sizes online serving pads its rounds to (online_warmup_plan).
    mesh must be None (one card). Runs on CUDA unless device='cpu'.
    """
    _not_ported(mesh, False)
    before = graphs.CAPTURES
    k = steps if steps is not None else cfg.stream_every
    live = resolve_batch_policy(cfg) == "batched"
    for aspect in aspects:
        h, w = bucket_content_shape(aspect, cfg)
        content = np.full((h, w, 3), 0.5, np.float32)
        style = np.full((cfg.base_diameter, cfg.base_diameter, 3), 0.5,
                        np.float32)
        for size in (batch_sizes or (None,)):
            t0 = time.time()
            if size is None:
                job = TransferJob(content, style, cfg, params=params,
                                  device=device)
            else:
                job = BatchedTransferJob([content] * size, [style] * size,
                                         cfg, params=params, device=device)
            for _ in job.run(iters_num=k, stream_every=k,
                             yield_images=False):
                pass
            if size is not None:
                job.warm_shrink_graphs()
                if live:  # the evaluation a live chunk replays
                    job.warm_live_chunk(k)
            if verbose:
                tag = "" if size is None else f" batch={size}"
                print(f"warmup: aspect {aspect:.3f} ({h}x{w}){tag} ready "
                      f"in {time.time() - t0:.1f}s", file=sys.stderr)
    return graphs.CAPTURES - before
