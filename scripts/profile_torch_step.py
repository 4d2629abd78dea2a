#!/usr/bin/env python3
"""Where the time of one optimization step goes in the PyTorch/CUDA port.

    python3 scripts/profile_torch_step.py [--steps 10] [--size 512]
        [--lanes 1] [--t-init lr] [--precision default]
        [--lbfgs-grams recompute] [--lbfgs-state-dtype float32] [--eager]

Builds the port's smoke job on the card (2 pyramid levels, full-width
VGG19 with seeded weights, seeded synthetic size x size images) — with
--lanes N > 1, N copies of it as one BatchedTransferJob (the batched
queue's unit of work) — runs a few warm-up steps of Adam and of L-BFGS
(--t-init: the first line-search trial, 'lr' or 'unit'; the batched queue
batches 'unit'; --lbfgs-grams and --lbfgs-state-dtype: the L-BFGS state
options), then traces `--steps` steps of each with torch.profiler
(CUDA activity) and prints one JSON line per optimizer. Each evaluation
replays the job's captured CUDA graph (the port's default on CUDA);
--eager runs it eagerly (graphs=False) instead:

- host wall ms per step over `--steps` untraced steps (and job-steps/s:
  lanes over it), and device-busy ms per step over as many traced ones
  (sum of CUDA kernel time; one stream, so kernels do not overlap);
- the device's idle share in the traced window, 1 - busy / span, where
  span runs from the first kernel's start to the last kernel's end on
  the device's timeline (the profiler's host overhead may lengthen it);
- device ms per step by group: cuDNN/cuBLAS convolution and matmul
  kernels, the port's own kernels (gram, gram_bwd, tv, tv_bwd), and the
  rest (elementwise, reductions, copies); and `cublas_matmul_ms_per_step`,
  the cuBLAS matrix products and GEMVs among them (not cuDNN's
  convolutions): the L-BFGS history contractions and the bicubic
  pyramid resize;
- kernel_launches_per_step: the CUDA kernels the traced window ran (its
  kernel events, memory copies and sets left out) over its steps, which a
  graph does not reduce; host_launches_per_step: the runtime calls that
  launched them from the host (a cudaGraphLaunch counts once; null when
  the profiler recorded no runtime calls); host_wait_ms_per_step: the
  host's time inside the runtime's copies and synchronisations (a
  device->host read waits there for the device), so that the wall less
  it is the host's own work;
- evals_per_step (traced window) and evals_per_step_untraced: loss and
  gradient evaluations per step, from the port's launch counters (one TV
  forward per level and evaluation; a lane's line search may take more
  than one), and device_busy_ms_per_eval;
- the fifteen kernels with the most device time.

Needs a CUDA device; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# substrings of the port's kernel symbols (kernels/csrc/*.cu; the templated
# kernels keep these names); tv_partial_kernel and tv_final_kernel are the
# two-launch TV forward of older checkouts, so that one of them profiled
# beside this one groups its TV time alike
OWN = {"gram_partial_kernel": "gram", "gram_reduce_kernel": "gram",
       "gram_bwd_kernel": "gram_bwd", "tv_fwd_kernel": "tv",
       "tv_bwd_kernel": "tv_bwd", "tv_partial_kernel": "tv",
       "tv_final_kernel": "tv", "conv3x3_relu_kernel": "conv_relu"}
# runtime calls in which the host waits for the device
HOST_WAITS = ("cudaMemcpy", "cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")
LIBRARY = ("conv", "cudnn", "xmma", "gemm", "sm90", "sm80", "cutlass",
           "implicit", "winograd", "fft")


def _group(name: str) -> str:
    for key, group in OWN.items():
        if key in name:
            return group
    low = name.lower()
    if any(k in low for k in LIBRARY):
        return "cudnn_cublas"
    return "other"


def _is_cublas_matmul(name: str) -> bool:
    low = name.lower()
    return (("gemm" in low or "gemv" in low or "splitkreduce" in low)
            and not any(k in low for k in ("conv", "implicit", "fprop",
                                            "dgrad", "wgrad", "cudnn")))


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def profile(job, steps: int, warmup: int):
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    from artstyletransfer_tpu_torch.kernels import LAUNCHES
    from chip_smoke import host_launches

    def evals():
        # one TV forward launch per level and loss evaluation
        return LAUNCHES["tv"] / len(job.level_shapes)

    it = job.run(iters_num=warmup + 2 * steps, stream_every=1,
                 yield_images=False)
    for _ in range(warmup):
        next(it)
    torch.cuda.synchronize()
    e0 = evals()
    t0 = time.perf_counter()  # wall clock without the profiler's overhead
    for _ in range(steps):
        next(it)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    e1 = evals()
    # CUDA activity only: no per-op host records to slow the host down
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            next(it)
        torch.cuda.synchronize()
    e2 = evals()
    groups = {"cudnn_cublas": 0.0, "gram": 0.0, "gram_bwd": 0.0, "tv": 0.0,
              "tv_bwd": 0.0, "conv_relu": 0.0, "other": 0.0}
    kernels = []
    matmul_ms = 0.0
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us <= 0 or evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        groups[_group(evt.key)] += us / 1e3
        if _is_cublas_matmul(evt.key):
            matmul_ms += us / 1e3
        kernels.append((us / 1e3, evt.count, evt.key))
    host, launches = host_launches(prof)
    wait_ms = sum(evt.cpu_time_total for evt in prof.key_averages()
                  if evt.key.startswith(HOST_WAITS)) / 1e3
    busy_ms = sum(groups.values())
    # the traced window's span on the device's timeline, first kernel
    # start to last kernel end: busy and span come from the same window
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    span_ms = (max(b for _, b in spans) - min(a for a, _ in spans)) / 1e3
    kernels.sort(reverse=True)
    return dict(
        wall_ms_per_step=wall_ms / steps,
        evals_per_step_untraced=(e1 - e0) / steps,
        evals_per_step=(e2 - e1) / steps,
        device_busy_ms_per_step=busy_ms / steps,
        device_busy_ms_per_eval=busy_ms / (e2 - e1),
        device_span_ms_per_step=span_ms / steps,
        device_idle_share=1.0 - busy_ms / span_ms,
        device_ms_per_step={k: v / steps for k, v in groups.items()},
        cublas_matmul_ms_per_step=matmul_ms / steps,
        kernel_launches_per_step=launches / steps,
        host_launches_per_step=None if host is None else host / steps,
        host_wait_ms_per_step=wait_ms / steps,
        top_kernels=[dict(name=k[:90], ms_per_step=ms / steps,
                          calls_per_step=n / steps)
                     for ms, n, k in kernels[:15]])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_step: no CUDA device visible", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--lanes", type=int, default=1)
    ap.add_argument("--t-init", choices=["lr", "unit"], default="lr")
    ap.add_argument("--precision", choices=["default", "high", "highest"],
                    default="default")
    ap.add_argument("--lbfgs-grams", choices=["recompute", "incremental"],
                    default="recompute")
    ap.add_argument("--lbfgs-state-dtype", choices=["float32", "bfloat16"],
                    default="float32")
    ap.add_argument("--eager", action="store_true",
                    help="evaluate eagerly instead of by CUDA graph replay")
    args = ap.parse_args()

    from chip_smoke import synthetic_pair
    from artstyletransfer_tpu_torch.config import Config
    from artstyletransfer_tpu_torch.engine.transfer import TransferJob
    from artstyletransfer_tpu_torch.models.weights import init_vgg19_params
    from artstyletransfer_tpu_torch.parallel import BatchedTransferJob

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    content, style = synthetic_pair(size=args.size)
    params = init_vgg19_params(seed=0)
    for optimizer in ("adam", "lbfgs"):
        cfg = Config(levels_num=2, base_diameter=args.size // 2,
                     optimizer=optimizer, lbfgs_t_init=args.t_init,
                     conv_precision=args.precision,
                     lbfgs_grams=args.lbfgs_grams,
                     lbfgs_state_dtype=args.lbfgs_state_dtype)
        graphs = False if args.eager else None
        if args.lanes > 1:
            job = BatchedTransferJob([content] * args.lanes,
                                     [style] * args.lanes, cfg, params=params,
                                     device="cuda", graphs=graphs)
        else:
            job = TransferJob(content, style, cfg, params=params,
                              device="cuda", graphs=graphs)
        prof = profile(job, args.steps, args.warmup)
        rec = dict(script="profile_torch_step", gpu=smi, size=args.size,
                   graphs=not args.eager,
                   optimizer=optimizer, lanes=args.lanes, t_init=args.t_init,
                   precision=args.precision, lbfgs_grams=args.lbfgs_grams,
                   lbfgs_state_dtype=args.lbfgs_state_dtype, steps=args.steps,
                   job_steps_per_s=args.lanes * 1e3 / prof["wall_ms_per_step"],
                   **prof)
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
