"""Captured evaluations: the port's compiled step.

The JAX package compiles its optimization chunk once per (shape, config)
with ``jax.jit`` and keeps the executable in a bounded cache
(``engine/transfer.py`` ``_COMPILE_CACHE``, ``parallel/batch.py``
``_BATCH_CACHE``). PyTorch runs eagerly, and one evaluation of the loss
and its gradient launches ~370 CUDA kernels, each issued by the host. The
port's counterpart captures one evaluation of a job's (B, n) lanes as a
CUDA graph and replays it: one host launch instead of hundreds.

``EvalGraph`` holds one captured evaluation:

- a static input x (B, n) and static targets (each level's content tap and
  style Grams, lane-stacked), allocated before the capture; static
  outputs, the (B,) losses and the (B, n) gradient. The per-level metrics
  are not captured (jobs compute them eagerly);
- the weights are bound at capture, so a cache key names them;
- a job binds the entry: its targets are copied in only when the entry's
  owner changes, so jobs of one key (one bucket, config and weights) share
  it;
- a per-device lock is held over the copy-in, the replay and the
  copy-out, and the copy-out moves the outputs into tensors the caller
  owns. All graphs of a device capture into one memory pool: a replay of
  one may overwrite memory that another's outputs live in, which the
  lock and the copy-out make harmless;
- the capture step is an argument: ``cuda_capture`` on the card (eager
  warm passes that trigger everything lazy, then ``torch.cuda.graph`` on
  a side stream in thread-local error mode); ``eager_capture`` runs the
  same static-buffer plumbing with the body called eagerly at each
  "replay", for the CPU tests. A failed capture raises; nothing falls
  back to eager.

The kernel wrappers called during a capture count their launches into
the capture's record (kernels.RECORDING), and each replay adds that record
to kernels.LAUNCHES, so launch counts mean the same graphed and eager.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Tuple

import torch

from .. import kernels

# Graphs captured in this process (a warmup's count, and the proof that a
# warmed run captures nothing).
CAPTURES = 0
# Eager passes before each capture: the first triggers everything lazy
# (the kernels' build, resize matrices, TV's occupancy query, cuDNN plans,
# cuBLAS workspaces on the capture stream); the second runs warm.
WARM_PASSES = 2

_lock = threading.Lock()
_device_locks: Dict[str, threading.Lock] = {}
_pools: Dict[str, tuple] = {}
_streams: Dict[str, torch.cuda.Stream] = {}


def _device_key(device) -> str:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def device_lock(device) -> threading.Lock:
    """The lock that serialises captures and replays on one device."""
    key = _device_key(device)
    with _lock:
        return _device_locks.setdefault(key, threading.Lock())


def _pool_and_stream(device):
    """The device's shared graph memory pool and its capture stream (one
    stream, so each cuBLAS workspace is made once, in a warm pass)."""
    key = _device_key(device)
    with _lock:
        if key not in _pools:
            _pools[key] = torch.cuda.graph_pool_handle()
            _streams[key] = torch.cuda.Stream(torch.device(key))
        return _pools[key], _streams[key]


Outputs = Tuple[torch.Tensor, ...]
Capture = Callable[[Callable[[], Outputs], torch.device],
                   Tuple[Callable[[], None], Outputs, Dict[str, int]]]


def cuda_capture(fn: Callable[[], Outputs], device):
    """Run fn WARM_PASSES times eagerly, then capture one call of it as a
    CUDA graph in the device's shared pool. Returns (replay, outputs,
    launches): replay() reruns the captured work on the current stream,
    overwriting `outputs`; launches are the kernel launches each replay
    makes. The caller holds the device lock. The capture runs with
    `device` current (a mesh's shard thread may have another one)."""
    pool, stream = _pool_and_stream(device)
    with torch.cuda.device(stream.device):
        current = torch.cuda.current_stream(stream.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            for _ in range(WARM_PASSES):
                fn()
        current.wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        launches: Dict[str, int] = {}
        kernels.RECORDING[stream.cuda_stream] = launches
        try:
            # thread-local: another job's thread may allocate or launch
            # eagerly on its own stream meanwhile
            with torch.cuda.graph(graph, pool=pool, stream=stream,
                                  capture_error_mode="thread_local"):
                out = fn()
        finally:
            del kernels.RECORDING[stream.cuda_stream]

    def replay():
        with torch.cuda.device(stream.device):
            graph.replay()

    return replay, out, launches


def eager_capture(fn: Callable[[], Outputs], device):
    """The test seam: cuda_capture's contract with fn called eagerly at
    each replay, its results copied into the first call's outputs. No
    main path uses it."""
    del device
    out = fn()

    def replay():
        for dst, src in zip(out, fn()):
            dst.copy_(src)

    return replay, out, {}


def _flat(targets):
    """The tensors of a targets tuple ((content, (grams...)) per level)."""
    return [t for content, grams in targets for t in (content, *grams)]


class EvalGraph:
    """One captured evaluation of B lanes: body(targets, x) -> ((B,)
    losses, (B, n) gradient), replayed against static buffers.

    x and targets give the static buffers' shapes and first values; the
    caller already holds the job's precision gate (cuDNN's TF32 choice is
    baked in at capture)."""

    def __init__(self, body, x: torch.Tensor, targets,
                 capture: Capture = cuda_capture):
        global CAPTURES
        self.lock = device_lock(x.device)
        self._index = x.device.index  # the card the replays count on
        self.x = x.detach().clone()
        self.targets = tuple(
            (content.detach().clone(), tuple(g.detach().clone()
                                             for g in grams))
            for content, grams in targets)
        self._owner = None
        with self.lock:
            t0 = time.perf_counter()
            self._replay, (self._f, self._g), self.launches = capture(
                lambda: body(self.targets, self.x), x.device)
            self.capture_s = time.perf_counter() - t0
        with _lock:
            CAPTURES += 1

    def __call__(self, owner, targets, x: torch.Tensor, t=None, d=None):
        """((B,) losses, (B, n) gradient) at x, or at x + t d (t (B, 1),
        written into the static input in one kernel), against `targets`,
        which are copied in only when `owner` did not bind the entry
        last. The results are the caller's own tensors."""
        with self.lock:
            if self._owner is not owner:
                for dst, src in zip(_flat(self.targets), _flat(targets)):
                    dst.copy_(src)
                self._owner = owner
            if t is None:
                self.x.copy_(x)
            else:
                torch.addcmul(x, t, d, out=self.x)
            self._replay()
            kernels.add_launches(self.launches, self._index)
            return self._f.clone(), self._g.clone()
