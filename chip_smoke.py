#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout, with no setup: it builds the port's CUDA
kernels from artstyletransfer_tpu_torch/kernels/csrc with nvcc, then

1. build    — compiles every kernel source (in parallel) and reports the
              card's name and power limit (nvidia-smi); both Gram
              libraries (forward and backward) and the conv library must
              hold tensor-core instructions (HMMA in `cuobjdump -sass`),
              no atomics, and no spills in their ptxas reports;
2. kernels  — calls each kernel on the card at every shape the main path
              gives it (Gram forward/backward in float32 and bfloat16, TV
              forward and backward at 512², 256² and 511x769), the batched
              Gram, Gram-backward and TV forward/backward at 8 lanes of the
              512 px shapes and at the queue phase's own lane counts and
              shapes (one launch each),
              and the fused conv3x3+bias+ReLU at all 26 convs of the
              truncated VGG19 at 512² and 256² inputs and at 8 images of
              the 512 px level's 13 (one launch each; plus one gradient
              check through its autograd Function), and the Gram
              forward/backward at the five style taps of a 2048 px image
              and TV both ways at 2048², at 1 and 4 lanes (rows tagged
              `size`: 2048); holds each against its
              plain PyTorch version with a stated tolerance, and times it
              (device time from torch.profiler) beside its bound, the plain
              version and one library call (the Gram and conv kernels also
              beside their bounds at the TF32 tensor-core rate, and two
              calls on the same inputs must give the same bits; the
              float32 Gram forward, the conv and both TV kernels must also
              be within max(1e-5, twice the plain version's) relative error
              of the same function in float64; the TV backward must be 0
              wherever its plain version is); and one `tv_autograd` row per
              lane count (1 and 8) and level shape: lane_total_variation
              forward and backward, host ms per call and the CUDA kernels
              of one call, beside the TvMeansFn path (the parent design's
              glue: sums, means, squares, plain backward);
3. golden   — reruns two of the JAX package's committed one-step goldens
              (tests/goldens) on the card at full float32 precision;
4. main     — drives the main path, Executor -> neural_style_transfer ->
              TransferJob, at full VGG19 width on seeded synthetic 512x512
              images: 10 L-BFGS steps (history 100, 25 line-search evals)
              then 20 Adam steps, 2 pyramid levels (256 and 512). The
              kernels' launch counters are zeroed just before and read just
              after; every kernel must have launched and the loss must be
              finite and lower than at the start;
5. queue    — drives the batched job queue, run_job_queue ->
              BatchedTransferJob, at full VGG19 width with the same config:
              8 Adam jobs in two aspect buckets (6 at 512x512, 2 at 384x512
              contents; mixed style sizes, canonicalized), once at the
              default precision (TF32 convs) and once at full float32,
              then 4 unit-opening L-BFGS jobs (batched by the 'auto'
              policy), each queue three times for a spread of its rates.
              Counters are zeroed before and read after each;
              every lane's loss must be finite and fall, the kernels'
              launches per batched evaluation must not depend on the number
              of lanes (TV: one forward and one backward per level), and at
              full float32 the first Adam lane must end
              within rtol 1e-3 of the same job run alone (whose steps/s is
              reported beside each queue's). The fused conv kernel is not
              on any path (VGG runs on cuDNN, as on XLA in the JAX
              package): its launches there are 0.
6. lbfgs_state — the main L-BFGS job (512 px, 2 levels, history 100) at
              (recompute, float32), (incremental, float32) and
              (incremental, bfloat16) L-BFGS state, and the 4-job
              unit-opening L-BFGS queue at (incremental, bfloat16): steps/s,
              peak memory and launches of each (counters zeroed before and
              read after each run; every kernel of the path must launch),
              losses finite and falling; the carried Grams of each
              incremental job's final state (saved by a second run's
              checkpoint) within 1e-5 of S Yᵀ and Y Yᵀ recomputed from its
              buffers (largest difference over largest entry); the bf16
              job's final loss beside the f32 job's; and the Gram
              refresh's cuBLAS GEMV at 1 and 8 lanes, f32 and bf16 rows,
              beside its bandwidth bound;
7. resume   — a bf16 carried-Gram L-BFGS job runs 6 steps, twice without a
              break, then with a checkpoint every 3 steps, stopped after
              step 3 and resumed, at the default precision and at
              conv_precision="highest"; the same with a 4-lane batch that
              shrinks at step 2 (stop_tol, stop_shrink: two lanes hold a
              black image, whose loss and gradient are exactly 0). The
              loaded state must equal the saved one bit for bit, and the
              resumed run the uninterrupted one: at 'highest' the two
              uninterrupted runs and the resumed one bit for bit; at the
              default precision bit for bit when the two uninterrupted
              runs agree bit for bit, else within twice their spread (the
              record then names the cause);
8. graphs   — the compiled step (engine/graphs.py). Phases 4-7 already
              evaluate by CUDA graph replay (the default on CUDA); here
              graphed and eager (graphs=False) meet. One evaluation at
              the main job's shapes (1 lane, 2 levels, 512 px) and at 8
              lanes, replayed against eager at the same x and at a trial
              point x + t d: losses and gradients bit-equal, else within
              the goldens' gate (loss rtol 1e-3, gradient 1e-3 of its
              largest entry), and the kernels' launches per replay equal
              eager's; one job graphed and eager in turns (Adam 20 steps,
              unit L-BFGS 10): steps/s, host launches and CUDA kernels
              per step, final images and losses within the goldens' gate
              (PSNR > 50 dB, loss rtol 1e-3); two concurrent jobs of two
              buckets through Executor, each within that gate of its solo
              run; warmup of every DEFAULT_ASPECT_BUCKETS bucket at sizes
              1, 2, 4 and 8 (graphs, seconds per capture, peak memory),
              then a padded queue round over three buckets that must
              capture nothing.
9. online   — live serving (parallel/live.py, runtime/online.py). The
              buckets it uses are warmed first (2 levels, 512 px, sizes
              1, 2, 4, 8); then OnlineBatchingExecutor(device="cuda")
              serves, with the counters zeroed before and read after:
              Adam, 3 jobs in the 512x512 bucket, then 2 more and 1 in
              the 384x512 bucket once the first progress arrives; unit
              L-BFGS with carried Grams, 2 jobs and 1 joiner. Printed:
              each newcomer's seconds to its first progress, each
              rebuild's ms and device memory (allocated before and after,
              peak), the live batches' job-steps/s beside run_job_queue's
              on the same Adam jobs, and the graphs captured, which must
              be 0. Held: every task finishes with losses finite and
              falling; no plain kernel version runs; a job that joined
              mid-flight at conv_precision="highest" ends within PSNR
              50 dB and loss rtol 1e-3 of the same job run alone; two
              runs of one job at 'highest' agree bit for bit through
              precision_gate alone (Adam and unit L-BFGS; the runs at
              'default' are reported); and what cuDNN's deterministic
              algorithms cost one 512 px evaluation (device ms, with the
              switch on and off, at 'highest' and at 'default').
10. frontends — the web lab and the Telegram bot (frontends/lab.py,
              tlbot.py) on CUDA, both resolving their VGG19 weights from
              a torchvision-layout .pth of the seeded weights named by
              ASTT_VGG19_WEIGHTS (load_vgg19_params() must give the
              seeded arrays bit for bit; the file and the weights cache
              live in the gitignored .smoke_weights/, removed after use).
              The lab's core (Lab) with its default online executor
              serves four demo pairs (three 512x512, one 384x512) at the
              standard preset cut to 10 steps, through the round path;
              the progress table is polled to 100%, and each task's
              latest image is fetched through the code /generated/<id>
              runs, and / and /generated/<id> through the aiohttp app
              on a test server. The bot, with an
              in-script transport, online batching and Adam (40 steps),
              after warmup_serving of the square bucket, serves two
              albums and a third sent once the first progress photo
              went out. Printed: each request's seconds to first
              progress and to done, each album's seconds to its first
              photo and to "Done!", job-steps/s, dispatch rounds, peak
              memory. Held: the kernels' launches (conv_relu 0), no plain
              kernel version, each album's transcript ("Processing has
              started", progress captions, one "Done!", no apology),
              final images finite and of their bucket's top-level shape,
              losses finite and falling. The image files are JPEG
              through OpenCV; OpenCV, aiohttp and jinja2 must import.
11. large   — the 4-level job with a 2048 px top level
              (Config(levels_num=4, base_diameter=256)), seeded 2048x2048
              images and weights, full VGG19 width, Adam graphed, with
              remat_levels off and on: 10 steps in chunks of 5 at 1 and 4
              lanes (TF32 convs), 3 steps at 1 lane at
              conv_precision="highest", then 8 lanes with remat and
              without, each run only if the peak extrapolated from the
              1- and 4-lane runs and parallel/memory.py's memory_stats
              both stay below 70 GB (else that extrapolation alone: an
              evaluation's measured peak is the top level's backward,
              ~10 GB a lane with remat or without, so 8 lanes do not fit
              an 80 GB card). Printed for each run:
              memory_stats' prediction (arguments, saved activations,
              the recomputed level) beside its measured peak_bytes and
              the run's own peak, construction and capture seconds,
              device ms per step after the first chunk (CUDA events
              around each step) and the launches of one evaluation,
              which must be
              gram 20, gram_bwd 20, tv 4, tv_bwd 4 without remat and gram
              40, tv 8 with it (the recomputed forward). Remat on against
              off: bit-equal final images and losses, else within rtol
              1e-5 (printed). Then one unit L-BFGS lane with carried Grams
              (production_config), remat on, 3 steps: its history GB
              beside the run's peak. Counters zeroed before and read
              after each run; losses finite and falling;
12. lookahead — pipeline_streaming on and off (on, off, on, off): a
              2048 px 4-level Adam job and a 512 px 2-level one, 20 steps
              in chunks of 5, graphed (captured before the run): seconds
              to the first and last yield, the device's idle ms at each
              chunk boundary and between steps inside a chunk (CUDA
              events around every step); every yielded image and loss
              bit-equal on and off;
13. builders — engine/builders.py's LossBuilder on the card at 512 px:
              (total, content, style, tv) within rtol 1e-5 of a one-level
              engine loss at the same image, its gradient finite; the
              Gram, Gram-backward and TV forward kernels launched and no
              plain kernel version called.
14. mesh    — jobs placed over several cards (parallel/mesh.py): every
              visible card when there are two or more, else a rehearsal
              mesh of the one card twice (jobs_mesh(devices=[cuda:0,
              cuda:0]): the shard threads, per-shard graphs and the
              lanes' moves between shards on a real card), said on its
              own line ({"mesh": "rehearsal, 1 card"}). Printed: the card
              count and each card's name and power limit; the queue
              phase's 8 Adam jobs at conv_precision="highest" through
              run_job_queue on the mesh and on no mesh, twice each
              (job-steps/s of both runs); each mesh job within PSNR > 50
              dB and loss rtol 1e-3 of itself on no mesh in a one-card
              batch of its shard's lanes, and within loss rtol 1e-3 of
              the no-mesh queue (its PSNR printed: other lane counts sum
              cuDNN's convolutions in other orders); a unit L-BFGS
              batch of 2A lanes (A the jobs axis; stop_tol, stop_shrink)
              on the mesh whose A black lanes leave at step 4, so each
              lane left moves to another shard (real lanes' losses
              finite and falling); one
              OnlineBatchingExecutor(mesh=...) session, two Adam jobs and
              a joiner; memory_stats(mesh=...) of a 4-lane 512 px batch
              per card beside each card's measured peak. Counters zeroed
              before and read after each run, per card: every card of the
              mesh must show gram, gram_bwd, tv and tv_bwd.
15. space   — one job's rows over the cards of a space row
              (parallel/space.py): the first two cards
              (jobs_space_mesh(1, 2)) and the first four where four are
              visible, else the rehearsal, cuda:0 named twice (said on
              its own line with the cards' names, power limits and peer
              access). The TV seam kernels (h_total and a halo row) at
              every block shape of the 2048 px 4-level job at S = 2 and
              4 against their plain versions and float64, the block's own
              rows in the kernels' bits. The block downscale forward and
              backward at every 2048 px block shape at S = 2 and 4, on
              that many cards where visible, against the whole one
              (1e-5 of the largest entry), and with its halo gradients
              dropped (a planted fault the check must catch). The large
              job at conv_precision="highest", eager on both sides,
              against the unsharded job on cuda:0: the first evaluation
              (loss rtol 1e-4, a rerun bit-equal; the gradient within
              1e-4 of the top level alone, and over four levels within
              twice the unsharded gradient's own move at an input one ulp
              away, which the same planted fault must fail), 5 Adam
              steps (losses finite, rtol 1e-3, each step moving the way
              the unsharded run's moves, the last below the first; PSNR
              printed), ms per step sharded and unsharded eager and
              unsharded graphed, host syncs of one evaluation; a unit
              L-BFGS lane with carried Grams and remat (production_config,
              2 steps: first loss rtol 1e-4, losses finite and falling,
              history GB per shard); the peak per card and memory_stats
              per shard for both lanes. Counters zeroed before and read
              after each run: every card of the row must show gram,
              gram_bwd, tv and tv_bwd.

Each phase prints one JSON line per run. Any failure raises and exits non-zero;
without a CUDA device it exits 1 before printing any result. The last
lines are the card's nvidia-smi line, the `kernels` summary and
{"ok": true, "device": {...}}. All images are numpy arrays made from
seeds (the frontends phase writes them to JPEG files). A
full record of every measurement is also written to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import asyncio
import contextlib
import io
import json
import os
import subprocess
import sys
import time
from unittest import mock

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet), for the bounds
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}
TF32_TC_OPS_PER_S = 495e12  # dense TF32 on the tensor cores

SRC = "artstyletransfer_tpu_torch/kernels/csrc/"
PALLAS = "artstyletransfer_tpu/ops/pallas_kernels.py"
KERNELS = {
    "gram": dict(source=SRC + "gram.cu", replaces=PALLAS + ":52"),
    "gram_bwd": dict(source=SRC + "gram_bwd.cu", replaces=PALLAS + ":107"),
    "tv": dict(source=SRC + "tv.cu", replaces=PALLAS + ":171"),
    "tv_bwd": dict(source=SRC + "tv.cu", replaces=PALLAS + ":222",
                   replaces_note="_tv_vjp_bwd, the VJP of _tv_impl: XLA in "
                                 "the JAX package, not a Pallas kernel"),
    "conv_relu": dict(source=SRC + "conv_relu.cu", replaces=PALLAS + ":267"),
    "lbfgs_coef": dict(source=SRC + "lbfgs.cu", replaces=None,
                       replaces_note="no TPU kernel: the L-BFGS two-loop "
                                     "coefficients, the host's numpy "
                                     "recursion (engine/lbfgs.py "
                                     "_two_loop_coefficients) on the card"),
    "vgg_glue": dict(source=SRC + "vgg_glue.cu", replaces=None,
                     replaces_note="no TPU kernel: VGG19's bias, ReLU and "
                                   "2x2 pool between the convs, which the "
                                   "JAX package leaves to XLA"),
    "vgg_glue_bwd": dict(source=SRC + "vgg_glue.cu", replaces=None,
                         replaces_note="no TPU kernel: the ReLU mask, the "
                                       "pool's routing and a tap's gradient "
                                       "add, XLA's in the JAX package"),
}
# kernels that only the L-BFGS step on the card launches (engine/
# lbfgs_card.py): a path runs them where its L-BFGS form engages
# (card_step), and no other path does
CARD_STEP_ONLY = ("lbfgs_coef",)
NOT_ON_PATH = {"conv_relu": "no path runs it: VGG19's convs stay on cuDNN, "
                            "as they stay on XLA in the JAX package"}
# (n = h*w, c) of the five style taps at 512 px (level 1) and 256 px
# (level 0): the Gram shapes of one loss evaluation
GRAM_SHAPES = [(512 * 512, 64), (256 * 256, 128), (128 * 128, 256),
               (64 * 64, 512), (32 * 32, 512),
               (256 * 256, 64), (128 * 128, 128), (64 * 64, 256),
               (32 * 32, 512), (16 * 16, 512)]
TV_SHAPES = [(512, 512), (256, 256)]     # one loss evaluation
TV_EXTRA = [(511, 769)]                  # an odd shape
LANES = 8                                # the widest batched rows
QUEUE_REPEATS = 3                        # runs of each queue (a spread)
# (lanes, level inputs (h, w)) of the batched rows: 8 lanes of the 512 px
# level, then the queue phase's own batches at both of their levels: 6 and
# 4 lanes of the 512x512 bucket (Adam, L-BFGS) and 2 lanes of the 384x512
# bucket, whose levels are level_shape(384, 512, l, 256)
BATCHED = [(LANES, [(512, 512)]),
           (6, [(512, 512), (256, 256)]),
           (4, [(512, 512), (256, 256)]),
           (2, [(512, 682), (256, 341)])]
# the large phase's top level (2048 px, 4 levels): its five Gram shapes
# at 1 and 4 lanes, and TV both ways (rows tagged size=2048)
LARGE_HW = 2048
LARGE_ROWS = [(1, [(LARGE_HW, LARGE_HW)]), (4, [(LARGE_HW, LARGE_HW)])]
# (h = w, cin, cout) of the truncated VGG19's 13 convs (conv1_1 .. conv5_1)
# at each level input, 512 px and 256 px
VGG_CONVS = [(1, 3, 64), (1, 64, 64), (2, 64, 128), (2, 128, 128),
             (4, 128, 256), (4, 256, 256), (4, 256, 256), (4, 256, 256),
             (8, 256, 512), (8, 512, 512), (8, 512, 512), (8, 512, 512),
             (16, 512, 512)]
CONV_SHAPES = [(size // div, cin, cout) for size in (512, 256)
               for div, cin, cout in VGG_CONVS]
TOL = {  # max |kernel - plain| / max |plain|
    ("gram", "float32"): 1e-4, ("gram", "bfloat16"): 1e-4,
    ("gram_bwd", "float32"): 1e-4,
    ("gram_bwd", "bfloat16"): 1e-2,  # output rounded to bf16 (2^-8)
    ("tv", "float32"): 1e-4, ("tv_bwd", "float32"): 1e-4,
    # 9*cin products per output summed in another order than cuDNN's
    # (TF32 off on both sides)
    ("conv_relu", "float32"): 1e-4, ("conv_relu_grad", "float32"): 1e-4,
}

RECORD = {}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cards_smi() -> list:
    """nvidia-smi's name and power limit of every visible card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()


def nvidia_smi() -> str:
    return cards_smi()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean time per call of fn on the device's clock (CUDA events around
    reps back-to-back calls): where the host launches more slowly than the
    device runs, this includes the gaps between launches."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _profiled_device_ms(fn, reps: int):
    """(mean device time per call of fn, kernels recorded): the summed
    duration of every CUDA kernel it launched (torch.profiler / CUPTI),
    gaps excluded."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us, kernels = 0.0, 0
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            total_us += float(getattr(evt, "self_device_time_total",
                                      getattr(evt, "self_cuda_time_total", 0)))
            kernels += evt.count
    return total_us / 1e3 / reps, kernels


def device_ms(fn, reps: int = 20, attempts: int = 5) -> float:
    """The profiler's device time per call of fn. Every call launches at
    least one kernel, so a profiler session that records fewer kernels
    than calls (it dropped some, and reads low) is retried; after
    `attempts` such sessions this raises, so that every `ms`, `plain_ms`
    and `library_ms` is measured the same way."""
    import torch

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        ms, kernels = _profiled_device_ms(fn, reps)
        if kernels >= reps and ms > 0:
            return ms
    raise RuntimeError(f"torch.profiler recorded fewer than {reps} CUDA "
                       f"kernels for {reps} calls in {attempts} sessions")


def timings(kernel_fn, plain_fn, library_fn):
    """Device ms of the kernel, its plain version and the library call
    (device_ms, kernels only), plus the kernel's per-call ms on the
    device's clock (cuda_ms, host gaps included), kept apart as
    `call_ms`."""
    return dict(ms=device_ms(kernel_fn), plain_ms=device_ms(plain_fn),
                library_ms=None if library_fn is None else device_ms(library_fn),
                call_ms=cuda_ms(kernel_fn))


def bound(bytes_moved: float, ops: float, dtype: str, rate=None):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / (rate or PEAK_OPS_PER_S[dtype]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tc_bounds(bytes_moved, ops, elem, bf16_products):
    """A kernel's two bounds: `ops` at the dtype's rate of earlier runs
    (`bound_ms`: f32 CUDA cores, bf16 tensor cores) and the 3xTF32
    design's work at the TF32 tensor-core rate (`bound_tc_ms`): 3 products
    for float32 operands, `bf16_products` for bfloat16 F (exact in TF32,
    no low part)."""
    dtype = "float32" if elem == 4 else "bfloat16"
    b_ms, b_by = bound(bytes_moved, ops, dtype)
    tc_ms, tc_by = bound(bytes_moved, (3 if elem == 4 else bf16_products)
                         * ops, dtype, TF32_TC_OPS_PER_S)
    return dict(bound_ms=b_ms, bound_by=b_by, bound_tc_ms=tc_ms,
                bound_tc_by=tc_by)


def gram_bounds(n, c, elem, lanes=1):
    """The Gram forward: F read once, n*c*(c+1) operations (G is
    symmetric: its upper triangle); one product for bfloat16 F (both low
    parts 0)."""
    return tc_bounds(lanes * (n * c * elem + c * c * 4),
                     lanes * n * c * (c + 1), elem, 1)


def gram_bwd_bounds(n, c, elem, lanes=1):
    """The Gram backward: F read and dF written, 2*n*c^2 operations; two
    products for bfloat16 F (its low part 0, g's not)."""
    return tc_bounds(lanes * (2 * n * c * elem + c * c * 4),
                     lanes * 2 * n * c * c, elem, 2)


def f64_check(name, out, ref, ref64, shape):
    """A float32 kernel's output against the same function in float64:
    (kernel's, plain version's) relative error; the kernel's must be at
    most max(1e-5, 2 x the plain version's), which alone errs by up to
    5e-5 at the largest Gram shapes, too much to judge the kernel by."""
    scale = float(ref64.abs().max())
    k_rel = float((out.double() - ref64).abs().max()) / scale
    p_rel = float((ref.double() - ref64).abs().max()) / scale
    if not k_rel <= max(1e-5, 2 * p_rel):
        raise AssertionError(f"{name} float32 {shape}: relative error "
                             f"{k_rel:.3e} against float64 (plain "
                             f"{p_rel:.3e})")
    return dict(rel_err_f64=k_rel, plain_rel_err_f64=p_rel)


def gram_f64_check(f, s, out, ref, shape):
    """The float32 Gram forward against the float64 Gram (f64_check)."""
    f64 = f.double()
    return f64_check("gram", out, ref,
                     (f64.transpose(-1, -2) @ f64) * s, shape)


def same_bits(name, out, again):
    """Two calls on the same inputs must give identical outputs."""
    import torch

    if not torch.equal(out, again):
        raise AssertionError(f"{name}: two calls on the same inputs differ")


def phase_build():
    from artstyletransfer_tpu_torch.kernels import build

    t0 = time.time()
    per_source = build.build_all(force=True)
    seconds = time.time() - t0
    ptxas = {}
    for name in build.SOURCES:
        with open(os.path.join(build.BUILD_DIR, f"{name}.log")) as fh:
            ptxas[name] = [ln.strip() for ln in fh
                           if "registers" in ln or "spill" in ln]
    smi = nvidia_smi()
    rec = {"phase": "build", "seconds": round(seconds, 3),
           "per_source_seconds": {k: round(v, 3) for k, v in per_source.items()},
           "gpu": smi,
           "gram_bwd": tc_sass(build, "gram_bwd", ptxas["gram_bwd"]),
           "gram": tc_sass(build, "gram", ptxas["gram"]),
           "conv_relu": tc_sass(build, "conv_relu", ptxas["conv_relu"])}
    emit(rec)
    RECORD["build"] = dict(rec, ptxas=ptxas)
    return smi


def tc_sass(build, name, ptxas_lines):
    """Proof from the built library `name` that its kernels run on the
    tensor cores: its SASS (cuobjdump -sass) counts HMMA instructions and
    no atomics, and its ptxas report shows no spills."""
    import re

    sass = subprocess.run([build.cuda_tool("cuobjdump"), "-sass",
                           build.lib_path(name)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    hmma = re.findall(r"\bHMMA[.\w]*", sass)
    atomics = len(re.findall(r"\b(?:ATOM|ATOMS|ATOMG|RED)\b", sass))
    spills = [ln for ln in ptxas_lines if "spill" in ln
              and not re.search(r"\b0 bytes spill stores, 0 bytes spill loads",
                                ln)]
    rec = dict(hmma=len(hmma), hmma_forms=sorted(set(hmma)),
               atomics=atomics, spills=spills,
               ptxas=[ln for ln in ptxas_lines if "registers" in ln])
    if not hmma or atomics or spills:
        raise AssertionError(f"{name} SASS/ptxas: {rec}")
    return rec


def _check(kernel, dtype, out, ref, shape):
    import torch

    err = float((out.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    rel = err / scale if scale > 0 else err
    tol = TOL[(kernel, dtype)]
    if not (rel <= tol and torch.isfinite(out.float()).all()):
        raise AssertionError(f"{kernel} {dtype} {shape}: relative error "
                             f"{rel:.3e} > {tol:.0e}")
    return err, rel, tol


def phase_kernels():
    import torch

    from artstyletransfer_tpu_torch.kernels import gram as kgram

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    # plain versions and library calls in full float32, like the kernels
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = []
    for dtype in ("float32", "bfloat16"):
        tdt = getattr(torch, dtype)
        for n, c in GRAM_SHAPES:
            # post-ReLU-like features, as the taps are
            f = torch.relu(torch.randn((n, c), generator=gen, device=dev)).to(tdt)
            s = 1.0 / (n * c)
            out = kgram.gram_cuda(f, s)
            ref = kgram.gram_plain(f, s)
            same_bits("gram", out, kgram.gram_cuda(f, s))
            torch.cuda.synchronize()
            err, rel, tol = _check("gram", dtype, out, ref, (n, c))
            elem = f.element_size()
            f64 = (gram_f64_check(f, s, out, ref, (n, c))
                   if dtype == "float32" else {})
            rows.append(dict(
                kernel="gram", dtype=dtype, n=n, c=c, max_abs_err=err,
                rel_err=rel, tol=tol, **f64, **gram_bounds(n, c, elem),
                **timings(lambda: kgram.gram_cuda(f, s),
                          lambda: kgram.gram_plain(f, s),
                          lambda: torch.matmul(f.T, f))))
            emit(dict(phase="kernels", **rows[-1]))

            g = torch.randn((c, c), generator=gen, device=dev) * s
            g = (g + g.T).contiguous()
            out = kgram.gram_bwd_cuda(f, g)
            ref = kgram.gram_bwd_plain(f, g)
            same_bits("gram_bwd", out, kgram.gram_bwd_cuda(f, g))
            torch.cuda.synchronize()
            err, rel, tol = _check("gram_bwd", dtype, out, ref, (n, c))
            g_lib = g.to(tdt)
            rows.append(dict(
                kernel="gram_bwd", dtype=dtype, n=n, c=c, max_abs_err=err,
                rel_err=rel, tol=tol, **gram_bwd_bounds(n, c, elem),
                **timings(lambda: kgram.gram_bwd_cuda(f, g),
                          lambda: kgram.gram_bwd_plain(f, g),
                          lambda: torch.matmul(f, g_lib))))
            emit(dict(phase="kernels", **rows[-1]))
    for h, w in TV_SHAPES + TV_EXTRA:
        tv_rows(gen, rows, 1, h, w)
    batched_rows(gen, rows)
    batched_rows(gen, rows, LARGE_ROWS, {"size": LARGE_HW})
    torch.cuda.empty_cache()
    tv_autograd_rows(gen)
    conv_rows(gen, rows)
    conv_grad_check(gen)
    glue_rows(gen, rows)
    RECORD["kernels"] = rows
    return rows


def one_launch(name, fn):
    """fn() must launch kernel `name` exactly once, whatever the lanes."""
    from artstyletransfer_tpu_torch.kernels import LAUNCHES

    before = LAUNCHES[name]
    out = fn()
    if LAUNCHES[name] - before != 1:
        raise AssertionError(f"{name}: {LAUNCHES[name] - before} launches "
                             "for one batched call")
    return out


def tap_grams(h, w):
    """(n, c) of the five style taps of an h x w level input (VGG19 pools
    2x2, rounding down, between taps)."""
    return [((h >> i) * (w >> i), c)
            for i, c in enumerate((64, 128, 256, 512, 512))]


def batched_rows(gen, rows, batched=BATCHED, tag=None):
    """The Gram forward/backward and TV forward/backward at each
    `batched` lane count and level, float32, one launch per call, against
    the batched plain versions; library (Gram): torch.bmm. `tag` is added
    to every row."""
    import torch

    from artstyletransfer_tpu_torch.kernels import gram as kgram

    dev = torch.device("cuda")
    tag = tag or {}
    for lanes, levels in batched:
        for n, c in [nc for h, w in levels for nc in tap_grams(h, w)]:
            f = torch.relu(torch.randn((lanes, n, c), generator=gen,
                                       device=dev))
            s = 1.0 / (n * c)
            out = one_launch("gram", lambda: kgram.gram_cuda(f, s))
            ref = kgram.gram_plain(f, s)
            same_bits("gram", out, kgram.gram_cuda(f, s))
            torch.cuda.synchronize()
            err, rel, tol = _check("gram", "float32", out, ref, (lanes, n, c))
            rows.append(dict(
                kernel="gram", dtype="float32", lanes=lanes, n=n, c=c,
                **tag, max_abs_err=err, rel_err=rel, tol=tol,
                **gram_f64_check(f, s, out, ref, (lanes, n, c)),
                **gram_bounds(n, c, 4, lanes),
                **timings(lambda: kgram.gram_cuda(f, s),
                          lambda: kgram.gram_plain(f, s),
                          lambda: torch.bmm(f.transpose(1, 2), f))))
            emit(dict(phase="kernels", **rows[-1]))

            g = torch.randn((lanes, c, c), generator=gen, device=dev) * s
            g = (g + g.transpose(1, 2)).contiguous()
            out = one_launch("gram_bwd", lambda: kgram.gram_bwd_cuda(f, g))
            ref = kgram.gram_bwd_plain(f, g)
            same_bits("gram_bwd", out, kgram.gram_bwd_cuda(f, g))
            torch.cuda.synchronize()
            err, rel, tol = _check("gram_bwd", "float32", out, ref,
                                   (lanes, n, c))
            rows.append(dict(
                kernel="gram_bwd", dtype="float32", lanes=lanes, n=n, c=c,
                **tag, max_abs_err=err, rel_err=rel, tol=tol,
                **gram_bwd_bounds(n, c, 4, lanes),
                **timings(lambda: kgram.gram_bwd_cuda(f, g),
                          lambda: kgram.gram_bwd_plain(f, g),
                          lambda: torch.bmm(f, g))))
            emit(dict(phase="kernels", **rows[-1]))
            del f, g, out, ref
        for h, w in levels:
            tv_rows(gen, rows, lanes, h, w, tag)


def tv_rows(gen, rows, lanes, h, w, tag=None):
    """The TV forward and backward kernels on `lanes` integer-valued h x w
    x 3 images (8-bit-like, so neighbours tie), one launch each whatever
    the lanes, against their plain versions (forward: tv and means;
    backward: the plain glue it replaces, with a distinct cotangent per
    lane) and against both in float64; two calls must give the same bits,
    and the backward must be 0 wherever the plain one is. Bounds: the
    forward reads y once and writes 5 floats per lane (6 operations per
    element); the backward reads y, g and the means once and writes the
    grad (13 operations per element). No single library call computes
    either."""
    import torch

    from artstyletransfer_tpu_torch.kernels import tv as ktv

    dev = torch.device("cuda")
    y = torch.randint(-128, 128, (lanes, h, w, 3), generator=gen,
                      device=dev).float()
    g = torch.rand((lanes,), generator=gen, device=dev) + 0.5
    shape = (lanes, h, w)
    tag = dict(tag or {}, **({} if lanes == 1 else {"lanes": lanes}))

    tv, means = one_launch("tv", lambda: ktv.tv_cuda(y))
    again = ktv.tv_cuda(y)
    same_bits("tv", torch.cat([tv[:, None], means], 1),
              torch.cat([again[0][:, None], again[1]], 1))
    ref_tv, ref_means = ktv.tv_plain(y)
    tv64, means64 = ktv.tv_plain(y.double())
    torch.cuda.synchronize()
    checks = [_check("tv", "float32", tv, ref_tv, shape),
              _check("tv", "float32", means, ref_means, shape)]
    f64 = [f64_check("tv", tv, ref_tv, tv64, shape),
           f64_check("tv", means, ref_means, means64, shape)]
    b_ms, b_by = bound(y.numel() * 4 + lanes * 20, 6 * y.numel(), "float32")
    rows.append(dict(
        kernel="tv", dtype="float32", **tag, h=h, w=w,
        max_abs_err=max(c[0] for c in checks),
        rel_err=max(c[1] for c in checks), tol=checks[0][2],
        **max(f64, key=lambda d: d["rel_err_f64"]),
        bound_ms=b_ms, bound_by=b_by,
        **timings(lambda: ktv.tv_cuda(y), lambda: ktv.tv_plain(y), None)))
    emit(dict(phase="kernels", **rows[-1]))

    out = one_launch("tv_bwd", lambda: ktv.tv_bwd_cuda(y, g, means))
    same_bits("tv_bwd", out, ktv.tv_bwd_cuda(y, g, means))
    ref = ktv.tv_bwd_plain(y, g, means)
    torch.cuda.synchronize()
    err, rel, tol = _check("tv_bwd", "float32", out, ref, shape)
    f64 = f64_check("tv_bwd", out, ktv.tv_bwd_plain(y, g, ref_means),
                    ktv.tv_bwd_plain(y.double(), g.double(), means64), shape)
    stray = int(((ref == 0) & (out != 0)).sum())
    if stray:
        raise AssertionError(f"tv_bwd {shape}: {stray} elements nonzero "
                             "where the plain backward is 0")
    b_ms, b_by = bound(y.numel() * 8 + lanes * 12, 13 * y.numel(), "float32")
    rows.append(dict(
        kernel="tv_bwd", dtype="float32", **tag, h=h, w=w, max_abs_err=err,
        rel_err=rel, tol=tol, **f64, zeros=int((ref == 0).sum()),
        bound_ms=b_ms, bound_by=b_by,
        **timings(lambda: ktv.tv_bwd_cuda(y, g, means),
                  lambda: ktv.tv_bwd_plain(y, g, means), None)))
    emit(dict(phase="kernels", **rows[-1]))


def host_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    """Host wall ms per call of fn over reps calls, ending in a
    synchronize: for calls too small to keep the device busy, the host's
    cost of issuing them."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def tv_autograd_rows(gen):
    """lane_total_variation forward and backward (torch.autograd.grad with
    a cotangent per lane) at the single-job level shapes, 1 and LANES
    lanes: host ms per call, the CUDA kernels of one call (torch.profiler)
    and their device ms, for the TV Function (one forward and one backward
    launch) and for the TvMeansFn path, the parent design's glue (sums from
    the forward kernel, means and squares in PyTorch, the plain backward).
    The Function must take at most 3 kernels per level."""
    import torch

    from artstyletransfer_tpu_torch.ops.tv import (TvMeansFn,
                                                   lane_total_variation)

    def means_path(y):
        m = TvMeansFn.apply(y)
        return m[:, 0] * m[:, 0] + m[:, 1] * m[:, 1]

    dev = torch.device("cuda")
    recs = []
    for lanes in (1, LANES):
        for h, w in TV_SHAPES:
            y = torch.randint(-128, 128, (lanes, h, w, 3), generator=gen,
                              device=dev).float().requires_grad_(True)
            g = torch.rand((lanes,), generator=gen, device=dev) + 0.5
            rec = dict(phase="kernels", kernel="tv_autograd", lanes=lanes,
                       h=h, w=w)
            grads = {}
            for name, f in (("means_path", means_path),
                            ("function", lane_total_variation)):
                def call(f=f):
                    return torch.autograd.grad(f(y), y, g)[0]

                grads[name] = call()
                ms, kernels = _profiled_device_ms(call, 20)
                rec[name] = dict(call_ms=host_ms(call), device_ms=ms,
                                 kernels_per_call=kernels / 20)
            torch.cuda.synchronize()
            rec["grad_max_abs_diff"] = float(
                (grads["function"] - grads["means_path"]).abs().max())
            emit(rec)
            recs.append(rec)
            if rec["function"]["kernels_per_call"] > 3:
                raise AssertionError(f"tv autograd: {rec}")
            _check("tv_bwd", "float32", grads["function"],
                   grads["means_path"], (lanes, h, w))
    RECORD["tv_autograd"] = recs


def conv_inputs(gen, size, cin, cout, images=1):
    """Post-ReLU-like activations, He-scaled HWIO weights, small biases."""
    import torch

    dev = torch.device("cuda")
    x = torch.relu(torch.randn((images, size, size, cin), generator=gen,
                               device=dev))
    w = torch.randn((3, 3, cin, cout), generator=gen, device=dev) * (
        2.0 / (9 * cin)) ** 0.5
    b = torch.randn((cout,), generator=gen, device=dev) * 0.1
    return x, w, b


def conv_rows(gen, rows):
    """The fused conv kernel at every conv of the truncated VGG19 at both
    level inputs, one image, and at LANES images of the 512 px level's 13
    convs (one launch per call, rows with `lanes`), against
    conv_relu_plain and against the same conv in float64; two calls must
    give the same bits. Library: cuDNN's F.conv2d on channels_last tensors
    (bias in the call), then ReLU. TF32 is off. Bounds: 2*P*9*Cin*Cout
    operations (P output pixels) over the f32 rate (`bound_ms`) and 3x
    them over the TF32 tensor-core rate (`bound_tc_ms`), or the bytes."""
    import torch
    import torch.nn.functional as F

    from artstyletransfer_tpu_torch.kernels import conv_relu as kconv

    shapes = [(1, size, cin, cout) for size, cin, cout in CONV_SHAPES]
    shapes += [(LANES, 512 // div, cin, cout)
               for div, cin, cout in VGG_CONVS]
    for images, size, cin, cout in shapes:
        x, w, b = conv_inputs(gen, size, cin, cout, images)
        out = one_launch("conv_relu", lambda: kconv.conv_relu_cuda(x, w, b))
        ref = kconv.conv_relu_plain(x, w, b)
        same_bits("conv_relu", out, kconv.conv_relu_cuda(x, w, b))
        torch.cuda.synchronize()
        shape = (images, size, cin, cout)
        err, rel, tol = _check("conv_relu", "float32", out, ref, shape)
        f64 = f64_check("conv_relu", out, ref,
                        kconv.conv_relu_plain(x.double(), w.double(),
                                              b.double()), shape)
        x_cl = x.permute(0, 3, 1, 2)  # NCHW view, channels_last memory
        w_cl = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        n_px = images * size * size
        lanes = {} if images == 1 else {"lanes": images}
        rows.append(dict(
            kernel="conv_relu", dtype="float32", **lanes, h=size, w=size,
            cin=cin, cout=cout,
            tensor_cores=kconv.uses_tensor_cores(x, w), max_abs_err=err,
            rel_err=rel, tol=tol, **f64,
            **tc_bounds((n_px * (cin + cout) + 9 * cin * cout + cout) * 4,
                        2 * n_px * 9 * cin * cout, 4, None),
            **timings(lambda: kconv.conv_relu_cuda(x, w, b),
                      lambda: kconv.conv_relu_plain(x, w, b),
                      lambda: torch.relu_(F.conv2d(x_cl, w_cl, b,
                                                   padding=1)))))
        emit(dict(phase="kernels", **rows[-1]))


def conv_grad_check(gen):
    """conv3x3_relu's autograd Function on the card (kernel forward,
    rematerialised plain backward) against plain autograd."""
    import torch

    from artstyletransfer_tpu_torch.kernels import conv_relu as kconv
    from artstyletransfer_tpu_torch.ops.conv_relu import conv3x3_relu

    args = conv_inputs(gen, 64, 64, 128)
    r = torch.randn((1, 64, 64, 128), generator=gen, device="cuda")
    grads = []
    for fn in (conv3x3_relu, kconv.conv_relu_plain):
        ts = [a.clone().requires_grad_(True) for a in args]
        (fn(*ts) * r).sum().backward()
        grads.append([t.grad for t in ts])
    torch.cuda.synchronize()
    errs = [_check("conv_relu_grad", "float32", a, b, "64x64, 64->128")[1]
            for a, b in zip(*grads)]
    rec = dict(phase="kernels", kernel="conv_relu_grad",
               rel_err_x_w_b=errs, tol=TOL[("conv_relu_grad", "float32")])
    emit(rec)
    RECORD["conv_relu_grad"] = rec


# the glue rows' level inputs (lanes, h, w, tags): the main job's two
# levels, the 2048 px job's four, 8 lanes of the 512 px level and its
# 256 px level, and the 384x512 aspect bucket's two levels (odd widths at
# every pool)
GLUE_LEVELS = ([(1, 512, 512, {}), (1, 256, 256, {})]
               + [(1, LARGE_HW >> k, LARGE_HW >> k,
                   {"lanes": 1, "size": LARGE_HW}) for k in range(4)]
               + [(LANES, 512, 512, {"lanes": LANES}),
                  (LANES, 256, 256, {"lanes": LANES})]
               + [(2, 512, 682, {"lanes": 2, "aspect": "384x512"}),
                  (2, 256, 341, {"lanes": 2, "aspect": "384x512"})])


def _halves(gen, shape, dtype, relu=False):
    """Channels_last values on a grid of halves in [-4, 4]: sums with a
    bias of halves stay exact, and 2x2 windows tie and hold zeros often."""
    import torch

    t = torch.round(torch.randn(shape, generator=gen, device="cuda") * 2) / 2
    t = t.clamp(-4, 4)
    if relu:
        t = torch.relu(t)
    return t.to(dtype).contiguous(memory_format=torch.channels_last)


def _glue_layers(lanes, h, w):
    """(layer, (B, C, H, W) of its conv output) of the 13 convs, VGG19's
    production taps (use_relu)."""
    from artstyletransfer_tpu_torch.models.vgg19 import _plan

    out = []
    for layer, (_, _cin, cout) in zip(_plan(True), VGG_CONVS):
        out.append((layer, (lanes, cout, h, w)))
        if layer.pool:
            h, w = h // 2, w // 2
    return out


def _per_op_glue(y, b, layer, last):
    """The per-op path's forward glue (what the kernel replaced): the bias
    added in place, ReLU, the pool with int64 indices."""
    import torch
    import torch.nn.functional as F

    pre = y.add_(b.view(1, -1, 1, 1))
    if last and layer.tap_pre:
        return pre
    post = torch.relu(pre)
    return F.max_pool2d(post, 2, 2, return_indices=True) if layer.pool \
        else post


def _per_op_glue_bwd(g, post, idx, t, layer):
    """The per-op path's backward glue: the pool's backward, autograd's add
    of a tap's gradient, threshold_backward."""
    import torch

    aten = torch.ops.aten
    if layer.pool:
        g = aten.max_pool2d_with_indices_backward(
            g, post, [2, 2], [2, 2], [0, 0], [1, 1], False, idx)
        return aten.threshold_backward(g, post, 0)
    if t is not None and not layer.tap_pre:
        g = t if g is None else g + t
    g = aten.threshold_backward(g, post, 0)
    return g + t if t is not None and layer.tap_pre else g


def glue_rows(gen, rows):
    """kernels/vgg_glue.py at every conv of GLUE_LEVELS' level inputs, in
    float32 (and bfloat16 at the main job's levels), one row per level and
    direction over its 13 convs: the kernels against their plain versions
    bit for bit on values of halves (ties, zeros), one launch a conv, two
    calls the same bits; device ms summed over the 13 (the kernel, the
    plain version, and as `library_ms` the per-op glue they replaced),
    against the bytes bound at 3.35 TB/s (each input read once, each
    output written once)."""
    import torch

    from artstyletransfer_tpu_torch.kernels import vgg_glue as kg

    for dtype in ("float32", "bfloat16"):
        tdt = getattr(torch, dtype)
        for lanes, h, w, tags in GLUE_LEVELS:
            if dtype == "bfloat16" and tags:
                continue
            layers = _glue_layers(lanes, h, w)
            e = torch.empty((), dtype=tdt).element_size()
            # ---- forward: y, bias per conv ----
            ys = [_halves(gen, shape, tdt) for _, shape in layers]
            bs = [(torch.round(torch.randn(shape[1], generator=gen,
                                           device="cuda") * 2) / 2).to(tdt)
                  for _, shape in layers]
            last = len(layers) - 1
            kw = [dict(pool=l.pool, keep_pre=l.tap_pre,
                       keep_post=not (k == last and l.tap_pre))
                  for k, (l, _) in enumerate(layers)]
            nbytes = 0
            for k, (layer, (b, c, hh, ww)) in enumerate(layers):
                out = one_launch("vgg_glue",
                                 lambda: kg.glue_cuda(ys[k].clone(), bs[k],
                                                      **kw[k]))
                again = kg.glue_cuda(ys[k].clone(), bs[k], **kw[k])
                ref = kg.glue_plain(ys[k].clone(), bs[k], **kw[k])
                for got, twice, want in zip(out, again, ref):
                    if want is None:
                        continue
                    same_bits("vgg_glue", got, twice)
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"vgg_glue {dtype} {layer.name} "
                            f"{(b, c, hh, ww)}: not the plain bits")
                n = b * c * hh * ww
                np_ = b * c * (hh // 2) * (ww // 2)
                nbytes += c * e + (n * e + np_ * (e + 1) if layer.pool else
                                   n * e * (1 + kw[k]["keep_pre"]
                                            + kw[k]["keep_post"]))
            torch.cuda.synchronize()
            fwd = (lambda: [kg.glue_cuda(y, b_, **a)
                            for y, b_, a in zip(ys, bs, kw)])
            plain = (lambda: [kg.glue_plain(y, b_, **a)
                              for y, b_, a in zip(ys, bs, kw)])
            lib = (lambda: [_per_op_glue(y, b_, l, k == last)
                            for k, (y, b_, (l, _)) in
                            enumerate(zip(ys, bs, layers))])
            base = dict(dtype=dtype, **tags, h=h, w=w, convs=len(layers),
                        max_abs_err=0.0, bit_equal=True)
            t_ms, by = bound(nbytes, 0, dtype)
            rows.append(dict(kernel="vgg_glue", **base, bytes=nbytes,
                             bound_ms=t_ms, bound_by=by,
                             **timings(fwd, plain, lib)))
            emit(dict(phase="kernels", **rows[-1]))
            del ys, fwd, plain, lib
            torch.cuda.empty_cache()
            # ---- backward: g from above, post or code, a tap's gradient --
            args, per_op, nbytes = [], [], 0
            for k, (layer, (b, c, hh, ww)) in enumerate(layers):
                post = _halves(gen, (b, c, hh, ww), tdt, relu=True)
                full = (b, c, hh, ww)
                if layer.pool:
                    _, pooled, code = kg.glue_plain(post, None, pool=True)
                    idx = torch.nn.functional.max_pool2d(
                        post, 2, 2, return_indices=True)[1]
                    g = _halves(gen, pooled.shape, tdt)
                    args.append(dict(g=g, code=code, size=(hh, ww)))
                    per_op.append((g, post, idx, None, layer))
                    n_in = g.numel() * (e + 1)
                else:
                    g = None if k == last else _halves(gen, full, tdt)
                    t = (_halves(gen, full, tdt) if layer.tap is not None
                         else None)
                    if g is None and layer.tap_pre:
                        continue  # the tap's gradient is the conv's as it is
                    args.append(dict(g=g, post=post, tap=t,
                                     tap_after=layer.tap_pre))
                    per_op.append((g, post, None, t, layer))
                    n_in = sum(x.numel() for x in (g, post, t)
                               if x is not None) * e
                    del post
                nbytes += n_in + b * c * hh * ww * e
            for a in args:
                got = one_launch("vgg_glue_bwd", lambda: kg.glue_bwd_cuda(**a))
                same_bits("vgg_glue_bwd", got, kg.glue_bwd_cuda(**a))
                if not torch.equal(got, kg.glue_bwd_plain(**a)):
                    raise AssertionError(f"vgg_glue_bwd {dtype} "
                                         f"{tuple(got.shape)}: not the "
                                         "plain bits")
            for a, po in zip(args, per_op):
                if not torch.equal(kg.glue_bwd_plain(**a), _per_op_glue_bwd(*po)):
                    raise AssertionError(f"vgg_glue_bwd {dtype}: the plain "
                                         "version is not the per-op bits")
            torch.cuda.synchronize()
            t_ms, by = bound(nbytes, 0, dtype)
            rows.append(dict(
                kernel="vgg_glue_bwd", **base, bytes=nbytes, bound_ms=t_ms,
                bound_by=by,
                **timings(lambda: [kg.glue_bwd_cuda(**a) for a in args],
                          lambda: [kg.glue_bwd_plain(**a) for a in args],
                          lambda: [_per_op_glue_bwd(*po) for po in per_op])))
            emit(dict(phase="kernels", **rows[-1]))
            del args, per_op
            torch.cuda.empty_cache()


def per_op_features(params, x, compute_dtype="float32", use_relu=True):
    """The truncated VGG19 as the port ran it before Vgg19Fn, op by op
    under autograd: tests/vgg_per_op.py's stack, the CPU tests' oracle."""
    here = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if here not in sys.path:
        sys.path.insert(0, here)
    from vgg_per_op import per_op_features as stack

    return stack(params, x, compute_dtype, use_relu)


def kernels_by_op(fn, top=16):
    """The CUDA kernels of one call of fn by the ATen operation that
    launched each (torch.profiler, CPU and CUDA activity; an eager fn:
    a graph's replay names no operation): the `top` (kernel, op) pairs by
    device ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by = {}
    for evt in prof.events():
        for k in evt.kernels:
            key = (k.name[:72], evt.name)
            by[key] = by.get(key, 0.0) + k.duration / 1e3
    return [dict(kernel=k, op=op, ms=ms) for (k, op), ms in
            sorted(by.items(), key=lambda kv: -kv[1])[:top]]


def glue_eval_checks(params, shapes=((2, 512), (4, LARGE_HW)),
                     device="cuda"):
    """One graphed evaluation (loss and gradient) of the 512 px bot job
    and of the 2048 px 4-level job (production_config), with Vgg19Fn,
    against the same job built and evaluated eagerly on per_op_features:
    the targets, the loss and the gradient bit for bit; the launches of
    one replay (13 of each glue kernel a level); device ms of one
    evaluation each way, and the kernels of an eager evaluation each way
    by the ATen operation that launched them (kernels_by_op)."""
    import dataclasses

    import torch

    from artstyletransfer_tpu_torch.config import (Config, precision_gate,
                                                   production_config)
    from artstyletransfer_tpu_torch.engine import transfer
    from artstyletransfer_tpu_torch.engine.transfer import TransferJob
    from artstyletransfer_tpu_torch.kernels import LAUNCHES, reset_launches

    out = []
    for levels, size in shapes:
        free_card()
        cfg = production_config(dataclasses.replace(
            Config(levels_num=levels), iters_num=1, stream_every=1), device)
        content, style = synthetic_pair(21, size)
        fused = TransferJob(content, style, cfg, params=params,
                            device=device)
        eager = TransferJob(content, style, cfg, params=params,
                            device=device, graphs=False)
        fused_eval = transfer.extract_features
        transfer.extract_features = per_op_features
        try:
            per_op = TransferJob(content, style, cfg, params=params,
                                 device=device, graphs=False)
        finally:
            transfer.extract_features = fused_eval
        x = fused._x0.clone()
        rec = dict(phase="glue", run="eval", levels=levels, size=size)
        with precision_gate(cfg.conv_precision):
            fused._loss_grad(x)  # captures
            torch.cuda.synchronize()
            reset_launches()
            f1, g1 = (t.clone() for t in fused._loss_grad(x))
            torch.cuda.synchronize()
            rec["launches_per_eval"] = {k: LAUNCHES[k] for k in
                                        ("vgg_glue", "vgg_glue_bwd")}
            transfer.extract_features = per_op_features
            try:
                f0, g0 = (t.clone() for t in per_op._loss_grad(x))
                torch.cuda.synchronize()
                rec["device_ms_per_op"] = device_ms(
                    lambda: per_op._loss_grad(x), reps=5)
                rec["per_op_kernels_by_op"] = kernels_by_op(
                    lambda: per_op._loss_grad(x))
            finally:
                transfer.extract_features = fused_eval
            rec["device_ms_fused_graphed"] = device_ms(
                lambda: fused._loss_grad(x), reps=5)
            rec["fused_kernels_by_op"] = kernels_by_op(
                lambda: eager._loss_grad(x))
        rec["targets_bit_equal"] = all(
            torch.equal(a[0], b[0]) and all(torch.equal(u, v)
                                            for u, v in zip(a[1], b[1]))
            for a, b in zip(fused.targets, per_op.targets))
        rec["loss_bit_equal"] = bool(torch.equal(f1, f0))
        rec["grad_bit_equal"] = bool(torch.equal(g1, g0))
        rec["loss_rel"] = float((f1.double() / f0.double() - 1).abs().max())
        rec["grad_rel"] = _rel(g1, g0)
        rec["grad_mismatches"] = int((g1 != g0).sum())
        emit(rec)
        out.append(rec)
        want = {"vgg_glue": 13 * levels, "vgg_glue_bwd": 13 * levels}
        if rec["launches_per_eval"] != want:
            raise AssertionError(f"glue eval: launches {rec}")
        if not (rec["targets_bit_equal"] and rec["loss_bit_equal"]
                and rec["grad_bit_equal"]):
            raise AssertionError(f"glue eval {size}: not the per-op bits "
                                 f"{rec}")
        del fused, eager, per_op
    RECORD["glue"] = out
    return out


def phase_glue():
    """The glue kernels on the evaluation: glue_eval_checks."""
    from artstyletransfer_tpu_torch.models.weights import init_vgg19_params

    return glue_eval_checks(init_vgg19_params(seed=0))


def _sums(sel):
    """Summed times and bounds of a set of kernel rows."""
    out = {k: sum(r[k] for r in sel)
           for k in ("ms", "plain_ms", "bound_ms", "bound_tc_ms")
           if sel and k in sel[0]}
    lib = [r["library_ms"] for r in sel]
    out["library_ms"] = None if None in lib else sum(lib)
    return out


def kernel_summary(rows, paths):
    """One entry per kernel: the single-job main path's float32 shapes of
    one loss evaluation (for conv_relu: the 26 VGG19 convs of one
    evaluation's forward), times summed over them (kernel, plain, library,
    bound; the Gram and conv kernels also their tensor-core bound);
    launches summed over the driven paths, and per path. Each kernel also
    carries `lanes8`: the same sums over its 8-lane (8-image) rows, and
    the Gram and TV kernels `size2048_lanes1` / `_lanes4`: the sums over
    the large phase's top-level rows, with their largest float64 error,
    and the TV kernels `seam2048`: the sums over the space phase's seam
    rows (seam_rows), with theirs."""
    main_tv = {(h, w) for h, w in TV_SHAPES}
    out = []
    for name, meta in KERNELS.items():
        sel = [r for r in rows if r["kernel"] == name
               and r["dtype"] == "float32" and "lanes" not in r
               and "seam" not in r
               and (not name.startswith("tv") or (r["h"], r["w"]) in main_tv)]
        t_bytes = sum(r["bound_ms"] for r in sel if r["bound_by"] == "bytes")
        t_ops = sum(r["bound_ms"] for r in sel if r["bound_by"] == "operations")
        sums = _sums(sel)
        extra = ({"launches_note": NOT_ON_PATH[name]}
                 if name in NOT_ON_PATH else {})
        if "bound_tc_ms" in sums:
            extra["bound_tc_ms"] = sums["bound_tc_ms"]
        lanes8 = [r for r in rows if r["kernel"] == name
                  and r.get("lanes") == LANES]
        if lanes8:
            extra["lanes8"] = _sums(lanes8)
        for lanes, _levels in LARGE_ROWS:
            big = [r for r in rows if r["kernel"] == name
                   and r.get("size") == LARGE_HW
                   and r.get("lanes", 1) == lanes]
            if big:
                extra[f"size{LARGE_HW}_lanes{lanes}"] = dict(
                    _sums(big), max_rel_err_f64=max(
                        (r.get("rel_err_f64", 0.0) for r in big)))
        seam = [r for r in rows if r["kernel"] == name and "seam" in r]
        if seam:
            extra["seam2048"] = dict(
                _sums(seam), rows=len(seam),
                max_rel_err_f64=max(r["rel_err_f64"] for r in seam))
        if "replaces_note" in meta:
            extra["replaces_note"] = meta["replaces_note"]
        out.append(dict(
            name=name, route="cuda", source=meta["source"],
            replaces=meta["replaces"],
            launches=sum(counts[name] for counts in paths.values()),
            launches_by_path={p: counts[name] for p, counts in paths.items()},
            **extra,
            max_abs_err=max(r["max_abs_err"] for r in sel),
            ms=sums["ms"],
            call_ms=sum(r["call_ms"] for r in sel),
            plain_ms=sums["plain_ms"],
            bound_ms=sums["bound_ms"],
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=sums["library_ms"]))
    return out


def psnr(a, b) -> float:
    import numpy as np

    mse = float(np.mean((np.clip(a, 0, 1) - np.clip(b, 0, 1)) ** 2))
    return 10 * np.log10(1.0 / max(mse, 1e-12))


def phase_golden():
    """The JAX package's one-step goldens (CPU float32) on the card with
    TF32 off: loss within rtol 1e-3, image PSNR > 50 dB (cuDNN's float32
    convolutions sum in other orders than XLA's)."""
    import numpy as np

    from artstyletransfer_tpu_torch.config import Config
    from artstyletransfer_tpu_torch.engine.transfer import TransferJob
    from artstyletransfer_tpu_torch.models.weights import init_vgg19_params

    params = init_vgg19_params(seed=0)
    specs = [("transfer_2lvl_adam_1step", dict(optimizer="adam")),
             ("transfer_2lvl_lbfgsref_1step",
              dict(optimizer="lbfgs", lbfgs_max_ls_steps=0,
                   lbfgs_history=10))]
    for name, kw in specs:
        data = np.load(os.path.join(ROOT, "tests", "goldens", f"{name}.npz"))
        cfg = Config(levels_num=2, iters_num=1, base_diameter=16,
                     stream_every=1, seed=7, conv_precision="highest", **kw)
        job = TransferJob(data["content"], data["style"], cfg, params=params)
        done, img, loss = list(job.run())[-1]
        rel = abs(loss / float(data["loss"]) - 1.0)
        p = psnr(img, data["image"])
        rec = dict(phase="golden", name=name, loss=loss,
                   golden_loss=float(data["loss"]), loss_rel_err=rel,
                   psnr_db=p)
        emit(rec)
        RECORD.setdefault("golden", []).append(rec)
        if not (done == 1 and rel <= 1e-3 and p > 50.0):
            raise AssertionError(f"golden {name}: {rec}")


def synthetic_pair(seed: int = 0, size: int = 512):
    """Seeded content/style images in [0, 1]: smooth color fields plus
    texture, so the VGG taps carry structure."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    content = np.stack([0.5 + 0.4 * np.sin(2 * np.pi * (k + 1) * xx + k)
                        * np.cos(2 * np.pi * (3 - k) * yy) for k in range(3)],
                       axis=-1)
    content += 0.05 * rng.standard_normal(content.shape)
    stripes = 0.5 + 0.5 * np.sin(40 * np.pi * (xx + yy))
    style = np.stack([stripes, 1 - stripes, 0.5 * stripes], axis=-1)
    style += 0.1 * rng.random(style.shape)
    return (np.clip(content, 0, 1).astype(np.float32),
            np.clip(style, 0, 1).astype(np.float32))


def run_executor(cfg, content, style, params):
    """One job through Executor -> neural_style_transfer on the card;
    returns (final image, start time, [(time, percent, image)] of every
    progress report)."""
    from functools import partial

    from artstyletransfer_tpu_torch.engine.transfer import (
        ContentStylePair, neural_style_transfer)
    from artstyletransfer_tpu_torch.runtime.executor import Executor

    stamps = []

    async def report(task_id, result):
        stamps.append((time.time(), result[0], result[1]))

    async def go():
        ex = Executor(cfg, report_progress=report, verbose=False,
                      engine=partial(neural_style_transfer, params=params),
                      device="cuda")
        await ex.add_task("smoke", ContentStylePair(("content", content),
                                                    ("style", style)))
        await ex.run()
        if ex.failures:
            raise next(iter(ex.failures.values()))

    t0 = time.time()
    asyncio.run(go())
    if not stamps or stamps[-1][1] < 100.0 or stamps[-1][2] is None:
        raise AssertionError("the job did not complete")
    return stamps[-1][2], t0, stamps


def phase_main():
    import numpy as np
    import torch

    from artstyletransfer_tpu_torch.config import Config
    from artstyletransfer_tpu_torch.engine.transfer import TransferJob
    from artstyletransfer_tpu_torch.kernels import LAUNCHES, reset_launches
    from artstyletransfer_tpu_torch.models.weights import init_vgg19_params

    content, style = synthetic_pair()
    params = init_vgg19_params(seed=0)
    runs = [("lbfgs", Config(levels_num=2, base_diameter=256, iters_num=10,
                             stream_every=5, optimizer="lbfgs")),
            ("adam", Config(levels_num=2, base_diameter=256, iters_num=20,
                            stream_every=10, optimizer="adam"))]
    results = []
    reset_launches()  # ---- the main path starts here ----
    for name, cfg in runs:
        before = dict(LAUNCHES)
        torch.cuda.reset_peak_memory_stats()
        img, t0, stamps = run_executor(cfg, content, style, params)
        torch.cuda.synchronize()
        wall = time.time() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        (t_a, p_a, _), (t_b, p_b, _) = stamps[-2], stamps[-1]
        steps_per_s = (p_b - p_a) / 100.0 * cfg.iters_num / (t_b - t_a)
        results.append((name, cfg, img, wall, steps_per_s, peak_gb,
                        {k: LAUNCHES[k] - before[k] for k in LAUNCHES}))
    launches = dict(LAUNCHES)  # ---- and ends here ----

    for name, cfg, img, wall, sps, peak_gb, counts in results:
        if img.shape != (512, 512, 3) or not np.isfinite(img).all():
            raise AssertionError(f"{name}: bad image {img.shape}")
        # losses at the start and the end, measured apart from the run
        job = TransferJob(content, style, cfg, params=params, device="cuda")
        first = job.initial_loss()
        last, per_level = job.loss_report(img)
        rec = dict(phase="main", optimizer=name, steps=cfg.iters_num,
                   wall_s=wall, steps_per_s_last_chunk=sps,
                   first_loss=first, last_loss=last, launches=counts,
                   peak_mem_gb=peak_gb)
        emit(rec)
        RECORD.setdefault("main", []).append(rec)
        if not (np.isfinite(last) and last < first):
            raise AssertionError(f"{name}: loss did not decrease: {rec}")
    check_launches("main", launches,
                   any(card_step(cfg) for _name, cfg in runs))
    return launches


def card_step(cfg, graphs=True):
    """Whether a path of cfg's jobs on plain CUDA lanes (no space row)
    steps L-BFGS on the card: engine/lbfgs_card.py engages for a graphed
    evaluation, the matrix direction and carried Grams."""
    return (graphs and cfg.optimizer == "lbfgs"
            and cfg.lbfgs_direction == "matrix"
            and cfg.lbfgs_grams == "incremental")


def check_launches(path, launches, on_card):
    """Every kernel of the path launched; the one no path runs did not;
    the L-BFGS step's own kernels launched if and only if the path steps
    on the card (on_card: card_step of its jobs)."""
    missing = [k for k, v in launches.items()
               if (v > 0) != (on_card if k in CARD_STEP_ONLY
                              else k not in NOT_ON_PATH)]
    if missing:
        raise AssertionError(f"{path}: launches {launches} (unexpected for "
                             f"{missing})")


def queue_jobs(size: int = 512):
    """8 Adam jobs (6 at size x size, 2 at 3/4 size x size contents; styles
    of four sizes: 512x512, 400x600, 300x300 and 640x480 at size 512) and 4
    L-BFGS jobs (size x size), all seeded synthetic images."""
    sizes = [(size, size), (size * 25 // 32, size * 75 // 64),
             (size * 75 // 128, size * 75 // 128),
             (size * 5 // 4, size * 15 // 16)]
    adam = []
    for i in range(8):
        content, _ = synthetic_pair(seed=i, size=size)
        if i >= 6:
            content = content[size // 8:size - size // 8]
        sh, sw = sizes[i % 4]
        _, style = synthetic_pair(seed=100 + i, size=max(sh, sw))
        adam.append((f"adam{i}", content, style[:sh, :sw]))
    lbfgs = [(f"lbfgs{i}",) + synthetic_pair(seed=20 + i, size=size)
             for i in range(4)]
    return adam, lbfgs


def run_queue(jobs, cfg, params):
    """run_job_queue on the card QUEUE_REPEATS times, with the counters
    zeroed just before the first run and read just after the last; returns
    (results, progress events of each run, launches, wall s of each run,
    peak GB)."""
    import torch

    from artstyletransfer_tpu_torch.kernels import LAUNCHES, reset_launches
    from artstyletransfer_tpu_torch.parallel import run_job_queue

    runs, walls = [], []
    torch.cuda.reset_peak_memory_stats()
    reset_launches()  # ---- the queue path starts here ----
    for _ in range(QUEUE_REPEATS):
        events = []

        def progress(tid, pct, img, loss, events=events):
            events.append((time.time(), tid, pct, loss))

        t0 = time.time()
        results, failures = run_job_queue(jobs, cfg, params=params,
                                          progress=progress,
                                          canonicalize_styles=True,
                                          device="cuda")
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
        runs.append(events)
        if failures:
            raise next(iter(failures.values()))
    launches = dict(LAUNCHES)  # ---- and ends here ----
    return (results, runs, launches, walls,
            torch.cuda.max_memory_allocated() / 1e9)


def chunk_rates(jobs, events, cfg):
    """Steady job-steps/s of each bucket: its lanes times the steps between
    its first and last progress chunk, over the time between them."""
    from artstyletransfer_tpu_torch.parallel.batch import bucket_jobs

    rates = []
    for bucket in bucket_jobs(jobs).values():
        tids = {j[0] for j in bucket}
        firsts = {}
        for t, tid, pct, _loss in events:
            if tid in tids:
                firsts[pct] = min(t, firsts.get(pct, t))
        (p_a, t_a), (p_b, t_b) = min(firsts.items()), max(firsts.items())
        rates.append(dict(lanes=len(bucket), content=bucket[0][1].shape[:2],
                          job_steps_per_s=len(bucket) * (p_b - p_a) / 100.0
                          * cfg.iters_num / (t_b - t_a)))
    return rates


def single_run(content, style, cfg, params):
    """One TransferJob of a queue job, QUEUE_REPEATS times: (steps/s
    between its first and last chunk in each run, the first run's final
    loss)."""
    from artstyletransfer_tpu_torch.engine.transfer import TransferJob

    job = TransferJob(content, style, cfg, params=params, device="cuda")
    rates, losses = [], []
    for _ in range(QUEUE_REPEATS):
        stamps = [(time.time(), done, loss) for done, _img, loss in job.run()]
        (t_a, d_a, _), (t_b, d_b, loss) = stamps[0], stamps[-1]
        rates.append((d_b - d_a) / (t_b - t_a))
        losses.append(loss)
    return rates, losses[0]


def launches_per_eval(content, style, cfg, params, lanes, graphs=None):
    """Kernel launches of one batched loss/grad evaluation of `lanes`
    copies of a job (by default a replay of its captured evaluation: the
    first call, which may capture, is not counted)."""
    import torch

    from artstyletransfer_tpu_torch.config import precision_gate
    from artstyletransfer_tpu_torch.kernels import LAUNCHES, reset_launches
    from artstyletransfer_tpu_torch.parallel import BatchedTransferJob

    job = BatchedTransferJob([content] * lanes, [style] * lanes, cfg,
                             params=params, device="cuda", graphs=graphs)
    with precision_gate(cfg.conv_precision):
        job._loss_grad(job._x0)
        torch.cuda.synchronize()
        reset_launches()
        job._loss_grad(job._x0)
        torch.cuda.synchronize()
    return dict(LAUNCHES)


def phase_queue():
    """The batched job queue at full width (see the module docstring)."""
    import numpy as np

    from artstyletransfer_tpu_torch.config import Config
    from artstyletransfer_tpu_torch.engine.pyramid import level_shape
    from artstyletransfer_tpu_torch.models.weights import init_vgg19_params
    from artstyletransfer_tpu_torch.parallel import BatchedTransferJob
    from artstyletransfer_tpu_torch.parallel.batch import (bucket_jobs,
                                                           canonicalize_style)

    params = init_vgg19_params(seed=0)
    adam_jobs, lbfgs_jobs = queue_jobs()
    adam = dict(levels_num=2, base_diameter=256, optimizer="adam",
                iters_num=20, stream_every=5)
    runs = [("adam", adam_jobs, Config(**adam)),
            ("adam_highest", adam_jobs,
             Config(conv_precision="highest", **adam)),
            ("lbfgs_unit", lbfgs_jobs,
             Config(levels_num=2, base_diameter=256, optimizer="lbfgs",
                    lbfgs_t_init="unit", iters_num=10, stream_every=2))]
    paths = {}
    for name, jobs, cfg in runs:
        results, runs_events, launches, walls, peak_gb = run_queue(
            jobs, cfg, params)
        events = runs_events[0]
        paths[f"queue_{name}"] = launches
        check_launches(f"queue {name}", launches, card_step(cfg))
        canon = [(tid, c, canonicalize_style(s, cfg)) for tid, c, s in jobs]
        first = {}
        for bucket in bucket_jobs(canon).values():
            batch = BatchedTransferJob([j[1] for j in bucket],
                                       [j[2] for j in bucket], cfg,
                                       params=params, device="cuda")
            first.update(zip([j[0] for j in bucket], batch.initial_losses()))
        lanes = {}
        for tid, c, _s in jobs:
            reported = [loss for _t, t2, _p, loss in events if t2 == tid]
            lanes[tid] = dict(first_loss=float(first[tid]),
                              first_chunk_loss=reported[0],
                              last_loss=reported[-1])
            img = results[tid]
            top = level_shape(*c.shape[:2], cfg.levels_num - 1,
                              cfg.base_diameter) + (3,)
            if img.shape != top or not np.isfinite(img).all():
                raise AssertionError(f"{name} {tid}: bad image {img.shape}")
            if not (np.isfinite(reported).all()
                    and reported[-1] < reported[0] < first[tid]):
                raise AssertionError(f"{name} {tid}: losses {lanes[tid]} "
                                     "are not finite and falling")
        tid0, c0, s0 = canon[0]
        single_rates, single_loss = single_run(c0, s0, cfg, params)
        rel = abs(lanes[tid0]["last_loss"] / single_loss - 1.0)
        per_eval = {n: launches_per_eval(c0, s0, cfg, params, n)
                    for n in (1, LANES)}
        steps = len(jobs) * cfg.iters_num
        rec = dict(phase="queue", optimizer=name, jobs=len(jobs),
                   steps=cfg.iters_num, repeats=QUEUE_REPEATS, wall_s=walls,
                   job_steps_per_s=[steps / w for w in walls],
                   chunk_rates=[chunk_rates(canon, ev, cfg)
                                for ev in runs_events],
                   single_job_steps_per_s=single_rates,
                   lane0_vs_single_rel_err=rel, lanes=lanes,
                   peak_mem_gb=peak_gb, launches=launches,
                   launches_per_eval={str(n): v for n, v in per_eval.items()})
        emit(rec)
        RECORD.setdefault("queue", []).append(rec)
        if per_eval[1] != per_eval[LANES]:
            raise AssertionError(f"{name}: launches per evaluation depend on "
                                 f"the lanes: {per_eval}")
        if any(per_eval[1][k] != cfg.levels_num for k in ("tv", "tv_bwd")):
            raise AssertionError(f"{name}: TV launches per evaluation "
                                 f"{per_eval[1]} are not one forward and one "
                                 f"backward per level ({cfg.levels_num})")
        if name == "adam_highest" and rel > 1e-3:
            raise AssertionError(f"adam lane 0 ends {rel:.2e} from the "
                                 "single job at full float32 (rtol 1e-3)")
    return paths


STATE_SETTINGS = [("recompute", "float32"), ("incremental", "float32"),
                  ("incremental", "bfloat16")]
SCRATCH = os.path.join(ROOT, ".smoke_ckpt")  # gitignored; removed after use


def lbfgs_cfg(**kw):
    """The main path's L-BFGS job: 512 px, 2 levels, history 100, 25
    line-search evaluations, 10 steps."""
    from artstyletransfer_tpu_torch.config import Config

    return Config(**{**dict(levels_num=2, base_diameter=256, iters_num=10,
                            stream_every=5, optimizer="lbfgs"), **kw})


def timed_run(it):
    """Drain a run's chunks, synchronising at each: [(time, done, loss)]."""
    import torch

    stamps = []
    for done, _img, loss in it:
        torch.cuda.synchronize()
        stamps.append((time.time(), done, float(loss)))
    return stamps


def gram_errors(path, cfg, n):
    """The carried Grams of a finished job's checkpoint against S Yᵀ and
    Y Yᵀ recomputed on the card from its buffers, in float32 and in
    float64: the largest difference over the largest entry. With bfloat16
    buffers P's diagonal holds y·s of the pair before it was quantised
    (as in the JAX package), so it is compared apart."""
    import torch

    from artstyletransfer_tpu_torch.engine import checkpoint as ckpt
    from artstyletransfer_tpu_torch.engine.transfer import _Lbfgs

    _x, st, _step = ckpt.load_checkpoint(path, _Lbfgs.leaf_specs(cfg, 1, n))
    k = int(min(int(st["count"].max()), cfg.lbfgs_history))
    S = st["s_hist"][0, :k].cuda().float()
    Y = st["y_hist"][0, :k].cuda().float()
    out = {"k": k}
    for name, carried, a, b in (("sy", st["sy_gram"][0, :k, :k], S, Y),
                                ("yy", st["yy_gram"][0, :k, :k], Y, Y)):
        carried = carried.cuda()
        off = torch.ones_like(carried)
        if name == "sy" and cfg.lbfgs_state_dtype == "bfloat16":
            off.fill_diagonal_(0.0)
        ref32 = a @ b.T
        ref64 = a.double() @ b.double().T
        scale = float((ref64 * off).abs().max())
        out[name] = dict(
            vs_f32=float(((carried - ref32) * off).abs().max()) / scale,
            vs_f64=float(((carried.double() - ref64) * off).abs().max())
            / scale,
            recompute_vs_f64=float(((ref32.double() - ref64) * off)
                                   .abs().max()) / scale)
        if name == "sy" and cfg.lbfgs_state_dtype == "bfloat16":
            diag = torch.diagonal(carried).double()
            out[name]["diag_vs_quantised_rel"] = float(
                ((diag - torch.diagonal(ref64)).abs()
                 / torch.diagonal(ref64).abs()).max())
    return out


def history_gemv_rows():
    """The Gram refresh's contraction, one (B, k, n)·(B, n, 1) product of
    the history rows with a pair, as engine/lbfgs.py's _bmm_f32 runs it
    (cuBLAS; bfloat16 rows through bmm's float32 output dtype) at 1 and 8
    lanes, k = 10 and 20 filled rows of the 512 px level: ms per call on
    the device's clock (cuda_ms: CUDA events around back-to-back calls;
    not a kernel of the port, so not the profiler's kernel-time rule),
    host ms per call, and the bound (the rows and the vector read once,
    the products written once, over HBM bandwidth)."""
    import torch

    from artstyletransfer_tpu_torch.engine.lbfgs import _bmm_f32

    n = 512 * 512 * 3
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    for lanes in (1, LANES):
        for k in (10, 20):
            for dtype in (torch.float32, torch.bfloat16):
                hist = torch.randn((lanes, k, n), device="cuda",
                                   generator=gen).to(dtype)
                vec = torch.randn((lanes, n, 1), device="cuda",
                                  generator=gen).to(dtype)
                elem = hist.element_size()
                bound_ms, _by = bound(lanes * (k * n + n) * elem
                                      + lanes * k * 4, 2 * lanes * k * n,
                                      "float32")

                def fn(hist=hist, vec=vec):
                    return _bmm_f32(hist, vec)

                rec = dict(phase="lbfgs_state", run="gemv", lanes=lanes,
                           k=k, dtype=str(dtype)[6:], ms=cuda_ms(fn),
                           host_ms=host_ms(fn), bound_ms=bound_ms)
                emit(rec)
                rows.append(rec)
                del hist, vec
    return rows


def phase_lbfgs_state():
    """The main L-BFGS job at (recompute, float32), (incremental, float32)
    and (incremental, bfloat16), and the 4-job unit-opening L-BFGS queue
    at (incremental, bfloat16). Each run's counters are zeroed just before
    it and read just after; every kernel of the path must have launched,
    every loss be finite and falling. The carried Grams of each
    incremental job's final state (a second run that saves it) must equal
    S Yᵀ and Y Yᵀ recomputed from its buffers within 1e-5 of the largest
    entry."""
    import shutil

    import numpy as np
    import torch

    from artstyletransfer_tpu_torch.engine.transfer import TransferJob
    from artstyletransfer_tpu_torch.kernels import LAUNCHES, reset_launches
    from artstyletransfer_tpu_torch.models.weights import init_vgg19_params

    content, style = synthetic_pair()
    params = init_vgg19_params(seed=0)
    paths, finals = {}, {}
    os.makedirs(SCRATCH, exist_ok=True)
    try:
        for grams, dtype in STATE_SETTINGS:
            cfg = lbfgs_cfg(lbfgs_grams=grams, lbfgs_state_dtype=dtype)
            job = TransferJob(content, style, cfg, params=params,
                              device="cuda")
            first = job.initial_loss()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()  # ---- this run of the path starts here ----
            t0 = time.time()
            stamps = timed_run(job.run())
            launches = dict(LAUNCHES)  # ---- and ends here ----
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            name = f"lbfgs_state_{grams}_{dtype}"
            paths[name] = launches
            check_launches(name, launches, card_step(cfg))
            (t_a, d_a, _), (t_b, d_b, last) = stamps[-2], stamps[-1]
            rec = dict(phase="lbfgs_state", run="job", lbfgs_grams=grams,
                       lbfgs_state_dtype=dtype, steps=cfg.iters_num,
                       wall_s=stamps[-1][0] - t0,
                       steps_per_s_last_chunk=(d_b - d_a) / (t_b - t_a),
                       first_loss=first, losses=[v for _t, _d, v in stamps],
                       peak_mem_gb=peak_gb, launches=launches)
            finals[(grams, dtype)] = last
            if grams == "incremental":
                path = os.path.join(SCRATCH, f"{name}.ckpt")
                list(TransferJob(content, style, cfg, params=params,
                                 device="cuda").run(
                    checkpoint_path=path, checkpoint_every=cfg.iters_num))
                rec["grams"] = gram_errors(path, cfg, job._x0.shape[1])
                os.remove(path)
            emit(rec)
            RECORD.setdefault("lbfgs_state", []).append(rec)
            losses = [v for _t, _d, v in stamps]
            if not (np.isfinite(losses).all() and losses[-1] < losses[0]
                    < first):
                raise AssertionError(f"{name}: losses not finite and "
                                     f"falling: {rec}")
            for key in ("sy", "yy"):
                if grams == "incremental" and not rec["grams"][key][
                        "vs_f32"] <= 1e-5:
                    raise AssertionError(f"{name}: carried {key} Gram "
                                         f"{rec['grams'][key]}")
    finally:
        shutil.rmtree(SCRATCH, ignore_errors=True)
    f32 = finals[("incremental", "float32")]
    bf16 = finals[("incremental", "bfloat16")]
    summary = dict(phase="lbfgs_state", run="final_loss_bf16_vs_f32",
                   rel=bf16 / f32 - 1.0)
    emit(summary)
    RECORD.setdefault("lbfgs_state", []).append(summary)

    _adam, lbfgs_jobs = queue_jobs()
    cfg = lbfgs_cfg(lbfgs_t_init="unit", stream_every=2,
                    lbfgs_grams="incremental", lbfgs_state_dtype="bfloat16")
    results, runs_events, launches, walls, peak_gb = run_queue(
        lbfgs_jobs, cfg, params)
    paths["lbfgs_state_queue"] = launches
    check_launches("lbfgs_state queue", launches, card_step(cfg))
    lanes = {}
    for tid, c, _s in lbfgs_jobs:
        reported = [loss for _t, t2, _p, loss in runs_events[0] if t2 == tid]
        lanes[tid] = dict(first_chunk_loss=reported[0],
                          last_loss=reported[-1])
        if not (np.isfinite(reported).all() and reported[-1] < reported[0]
                and np.isfinite(results[tid]).all()):
            raise AssertionError(f"lbfgs_state queue {tid}: {lanes[tid]}")
    steps = len(lbfgs_jobs) * cfg.iters_num
    rec = dict(phase="lbfgs_state", run="queue", lbfgs_grams="incremental",
               lbfgs_state_dtype="bfloat16", jobs=len(lbfgs_jobs),
               steps=cfg.iters_num, wall_s=walls,
               job_steps_per_s=[steps / w for w in walls],
               chunk_rates=[chunk_rates(lbfgs_jobs, ev, cfg)
                            for ev in runs_events],
               lanes=lanes, peak_mem_gb=peak_gb, launches=launches)
    emit(rec)
    RECORD.setdefault("lbfgs_state", []).append(rec)
    RECORD["lbfgs_state"].extend(history_gemv_rows())
    return paths


def _host_copy(leaves):
    import numpy as np

    return {k: v.detach().cpu().clone() if hasattr(v, "detach")
            else np.array(v) for k, v in leaves.items()}


def checkpointed_run(make, every, stop_at, path):
    """Run `make()`'s run with a checkpoint every `every` steps, keeping a
    host copy of what each save wrote, and stop it (as a crash would)
    after the chunk that ends at `stop_at`. Returns the copy of the last
    save."""
    from artstyletransfer_tpu_torch.engine import checkpoint as ckpt

    real_save, saved = ckpt.save_checkpoint, {}

    def keep(p, x, opt_state, step, **kw):
        saved.clear()
        saved.update(x=x.detach().cpu().clone(), step=step,
                     leaves=_host_copy(opt_state),
                     aux=_host_copy(kw.get("aux") or {}))
        real_save(p, x, opt_state, step, **kw)

    ckpt.save_checkpoint = keep
    try:
        it = make().run(checkpoint_path=path, checkpoint_every=every)
        for done, _imgs, _losses in it:
            if done >= stop_at:
                break
        it.close()
    finally:
        ckpt.save_checkpoint = real_save
    return saved


def same_as_saved(path, saved, specs):
    """The file's x, leaves and aux equal what the run saved, bit for bit."""
    import torch

    from artstyletransfer_tpu_torch.engine import checkpoint as ckpt

    x, leaves, step, _extra, aux = ckpt.load_checkpoint(
        path, specs, with_extra=True, with_aux=True)
    return (step == saved["step"] and torch.equal(x, saved["x"])
            and all(torch.equal(leaves[k], v)
                    for k, v in saved["leaves"].items())
            and set(aux) == set(saved["aux"])
            and all(torch.equal(aux[k], torch.as_tensor(v))
                    for k, v in saved["aux"].items()))


def resume_verdict(name, a, b, r, precision="default"):
    """a, b: (images, losses) of two uninterrupted runs; r: the resumed
    run's. At 'highest' (cuDNN's deterministic algorithms, through
    precision_gate) a and b must agree bit for bit and r with them. At a
    TF32 precision r must equal a bit for bit when a and b do; else
    within twice their spread (the record then names the cause)."""
    import numpy as np

    det = np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    rec = dict(precision=precision, uninterrupted_bit_equal=bool(det),
               resumed_bit_equal=bool(np.array_equal(a[0], r[0])
                                      and np.array_equal(a[1], r[1])),
               spread_img=float(np.abs(a[0] - b[0]).max()),
               resumed_vs_first_img=float(np.abs(a[0] - r[0]).max()),
               spread_loss=float(np.abs(np.asarray(a[1]) - b[1]).max()),
               resumed_vs_first_loss=float(np.abs(np.asarray(a[1])
                                                  - r[1]).max()))
    if det or precision == "highest":
        ok = det and rec["resumed_bit_equal"]
    else:
        rec["cause"] = ("two uninterrupted runs differ on the card: at a "
                        "TF32 precision precision_gate leaves cuDNN's "
                        "deterministic algorithms off")
        ok = (rec["resumed_vs_first_img"] <= 2 * rec["spread_img"]
              and rec["resumed_vs_first_loss"] <= 2 * rec["spread_loss"])
    if not ok:
        raise AssertionError(f"resume {name}: {rec}")
    return rec


def phase_resume():
    """Checkpoint and resume on the card (see the module docstring)."""
    import shutil

    import numpy as np

    from artstyletransfer_tpu_torch.engine.transfer import (TransferJob,
                                                            _Lbfgs)
    from artstyletransfer_tpu_torch.kernels import LAUNCHES, reset_launches
    from artstyletransfer_tpu_torch.models.weights import init_vgg19_params
    from artstyletransfer_tpu_torch.parallel import BatchedTransferJob

    params = init_vgg19_params(seed=0)
    content, style = synthetic_pair()
    state = dict(lbfgs_grams="incremental", lbfgs_state_dtype="bfloat16")
    paths = {}
    os.makedirs(SCRATCH, exist_ok=True)
    try:
        # one job: 6 steps, a checkpoint every 3, resumed from step 3; at
        # the default precision (TF32 convs) and at 'highest'
        for precision, path_name in (("default", "resume_job"),
                                     ("highest", "resume_job_highest")):
            cfg = lbfgs_cfg(iters_num=6, stream_every=3,
                            conv_precision=precision, **state)

            def job(cfg=cfg):
                return TransferJob(content, style, cfg, params=params,
                                   device="cuda")

            def final(it):
                _d, img, loss = list(it)[-1]
                return img, np.float32(loss)

            reset_launches()  # ---- this run of the path starts here ----
            a = final(job().run())
            paths[path_name] = dict(LAUNCHES)  # ---- and ends here ----
            check_launches(path_name, paths[path_name], card_step(cfg))
            b = final(job().run())
            path = os.path.join(SCRATCH, f"job_{precision}.ckpt")
            saved = checkpointed_run(job, 3, 3, path)
            loaded_ok = same_as_saved(
                path, saved, _Lbfgs.leaf_specs(cfg, 1, saved["x"].numel()))
            r = final(job().run(checkpoint_path=path, checkpoint_every=3,
                                resume=True))
            rec = dict(phase="resume", run="job", steps=6, saved_step=3,
                       loaded_equals_saved=loaded_ok,
                       **resume_verdict("job", a, b, r, precision))
            emit(rec)
            RECORD.setdefault("resume", []).append(rec)
            if not loaded_ok:
                raise AssertionError(
                    f"resume job: loaded state differs: {rec}")

        # four lanes that shrink at step 2: lanes 0 and 2 hold a black
        # image as content, style and start (one level, so no resize
        # rounds it), so their loss and gradient are exactly 0 and they
        # latch at once; lanes 1 and 3 are L-BFGS queue jobs that do not
        # settle within 1e-4 in 6 steps and run on as a batch of two
        from artstyletransfer_tpu_torch.engine.init_pipeline import (
            build_init_image)

        _adam, lbfgs_jobs = queue_jobs()
        black = np.zeros_like(content)
        bcfg = lbfgs_cfg(levels_num=1, base_diameter=512, iters_num=6,
                         stream_every=1, lbfgs_t_init="unit", stop_tol=1e-4,
                         stop_shrink=True, **state)
        lanes = [(black, black, black)]
        for i, (_t, c, s_img) in enumerate(lbfgs_jobs[:2]):
            init, _name = build_init_image(
                bcfg.init_method, c, s_img, bcfg,
                rng=np.random.default_rng(bcfg.seed + 2 * i + 1))
            lanes.append((c, s_img, init))
        lanes = [lanes[0], lanes[1], lanes[0], lanes[2]]

        def batch():
            return BatchedTransferJob([c for c, _s, _i in lanes],
                                      [s_ for _c, s_, _i in lanes], bcfg,
                                      params=params, device="cuda",
                                      init_overrides=[i for *_cs, i in lanes])

        def final_b(it):
            _d, imgs, losses = list(it)[-1]
            return imgs, np.asarray(losses)

        reset_launches()  # ---- this run of the path starts here ----
        a = final_b(batch().run())
        paths["resume_batch"] = dict(LAUNCHES)  # ---- and ends here ----
        check_launches("resume batch", paths["resume_batch"],
                       card_step(bcfg))
        b = final_b(batch().run())
        path = os.path.join(SCRATCH, "batch.ckpt")
        saved = checkpointed_run(batch, 3, 3, path)
        from artstyletransfer_tpu_torch.engine import checkpoint as ckpt

        step, extra = ckpt.peek_checkpoint_meta(path)
        live = len(extra["lane_orig"])
        loaded_ok = same_as_saved(
            path, saved, _Lbfgs.leaf_specs(bcfg, live, saved["x"].shape[1]))
        r = final_b(batch().run(checkpoint_path=path, checkpoint_every=3,
                                resume=True))
        rec = dict(phase="resume", run="batch", lanes=4, steps=6,
                   stop_tol=bcfg.stop_tol, saved_step=step,
                   lanes_in_checkpoint=live,
                   frozen_in_checkpoint=[o for o, _l in extra["finished"]],
                   loaded_equals_saved=loaded_ok,
                   **resume_verdict("batch", a, b, r))
        emit(rec)
        RECORD.setdefault("resume", []).append(rec)
        if not (loaded_ok and live == 2
                and sorted(rec["frozen_in_checkpoint"]) == [0, 2]):
            raise AssertionError(f"resume batch: {rec}")
    finally:
        shutil.rmtree(SCRATCH, ignore_errors=True)
    return paths


GRAPH_GATE = dict(loss_rtol=1e-3, grad_rel=1e-3, psnr_db=50.0)
# CUDA API calls (cuda* and cu*) that launch work from the host: a kernel, a
# cluster launch, or a whole CUDA graph (one call, however many kernels)
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel",
                     "cudaLaunchCooperativeKernel", "cudaGraphLaunch",
                     "cuGraphLaunch")


def host_launches(prof):
    """(host launches, CUDA kernels) recorded by a torch.profiler session:
    the runtime calls of HOST_LAUNCH_CALLS (a graph launch counts once)
    and the kernels the device ran. Host launches are None when the
    session recorded no runtime calls."""
    import torch

    calls = launches = kernels = 0
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            if not evt.key.startswith(("Memcpy", "Memset")):
                kernels += evt.count
        elif evt.key.startswith(("cuda", "cu")):
            calls += evt.count
            if evt.key.startswith(HOST_LAUNCH_CALLS):
                launches += evt.count
    return (launches if calls else None), kernels


def step_profile(job, warm: int = 2, steps: int = 5):
    """Host launches and CUDA kernels per step over `steps` steps of a
    job's run, after `warm` steps (torch.profiler, CUDA activity)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    it = job.run(iters_num=warm + steps, stream_every=1, yield_images=False)
    for _ in range(warm):
        next(it)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            next(it)
        torch.cuda.synchronize()
    it.close()
    launches, kernels = host_launches(prof)
    return dict(host_launches_per_step=(None if launches is None
                                        else launches / steps),
                kernels_per_step=kernels / steps)


def _rel(a, b):
    """max |a - b| / max |b| (float64)."""
    a, b = a.double(), b.double()
    scale = float(b.abs().max())
    return float((a - b).abs().max()) / scale if scale > 0 else 0.0


def eval_check(name, eager, graphed, cfg):
    """One evaluation of `graphed` (a replay) against `eager` at x0 + noise
    and at the trial point x0 + t (x1 - x0): losses and gradients, the
    kernels' launches of one evaluation each way, host ms per evaluation
    and the capture's seconds."""
    import torch

    from artstyletransfer_tpu_torch.config import precision_gate
    from artstyletransfer_tpu_torch.kernels import LAUNCHES, reset_launches

    x0 = eager._x0
    gen = torch.Generator(device="cuda").manual_seed(5)
    x1 = x0 + 8.0 * torch.randn(x0.shape, generator=gen, device="cuda")
    t = torch.full((x0.shape[0], 1), 0.25, device="cuda")
    rec = dict(phase="graphs", run="eval", name=name, lanes=x0.shape[0])
    with precision_gate(cfg.conv_precision):
        t0 = time.perf_counter()
        graphed._loss_grad(x0)  # captures
        torch.cuda.synchronize()
        rec["first_call_s"] = time.perf_counter() - t0
        rec["capture_s"] = graphed._loss_grad._graph.capture_s
        out, counts = {}, {}
        for way, job in (("eager", eager), ("graphed", graphed)):
            job._loss_grad(x1)
            torch.cuda.synchronize()
            reset_launches()
            out[way] = job._loss_grad(x1)
            torch.cuda.synchronize()
            counts[way] = dict(LAUNCHES)
            out[way + "_along"] = job._loss_grad.along(x0, t, x1 - x0)
            rec[way + "_eval_ms"] = host_ms(lambda: job._loss_grad(x1),
                                            reps=20, warmup=3)
        again = eager._loss_grad(x1)
        torch.cuda.synchronize()
    rec["launches_eager"], rec["launches_graphed"] = (counts["eager"],
                                                      counts["graphed"])
    rec["eager_rerun_bit_equal"] = bool(
        torch.equal(again[0], out["eager"][0])
        and torch.equal(again[1], out["eager"][1]))
    ok = counts["eager"] == counts["graphed"]
    for at in ("", "_along"):
        (fe, ge), (fg, gg) = out["eager" + at], out["graphed" + at]
        bit = bool(torch.equal(fe, fg) and torch.equal(ge, gg))
        loss_rel = float(((fg.double() / fe.double()) - 1.0).abs().max())
        grad_rel = _rel(gg, ge)
        rec["x1" + at] = dict(bit_equal=bit, loss_rel=loss_rel,
                              grad_rel=grad_rel)
        ok = ok and (bit or (loss_rel <= GRAPH_GATE["loss_rtol"]
                             and grad_rel <= GRAPH_GATE["grad_rel"]))
    emit(rec)
    RECORD.setdefault("graphs", []).append(rec)
    if not ok:
        raise AssertionError(f"graphs eval {name}: {rec}")
    return rec


def job_runs(content, style, params):
    """One job graphed and eager in turns (eager, graphed, graphed,
    eager): Adam 20 steps and unit L-BFGS 10 steps at the main job's
    shapes; steps/s past the first chunk (which holds a graphed job's
    capture), host launches and CUDA kernels per step, and the final
    images and losses graphed against eager."""
    import numpy as np
    import torch

    from artstyletransfer_tpu_torch.config import Config
    from artstyletransfer_tpu_torch.engine.transfer import TransferJob
    from artstyletransfer_tpu_torch.kernels import LAUNCHES, reset_launches

    runs = [("adam", Config(levels_num=2, base_diameter=256, iters_num=20,
                            stream_every=5, optimizer="adam")),
            ("lbfgs_unit", lbfgs_cfg(lbfgs_t_init="unit"))]
    reset_launches()  # ---- this run of the path starts here ----
    recs = []
    for name, cfg in runs:
        finals, rates, profiles = {}, {}, {}
        for graphed in (False, True, True, False):
            way = "graphed" if graphed else "eager"
            job = TransferJob(content, style, cfg, params=params,
                              device="cuda", graphs=graphed)
            stamps = []
            for done, img, loss in job.run():
                torch.cuda.synchronize()
                stamps.append((time.perf_counter(), done, img, loss))
            (t_a, d_a, _i, _l), (t_b, d_b, img, loss) = stamps[0], stamps[-1]
            rates.setdefault(way, []).append((d_b - d_a) / (t_b - t_a))
            finals.setdefault(way, (img, np.float32(loss)))
            if way not in profiles:
                profiles[way] = step_profile(
                    TransferJob(content, style, cfg, params=params,
                                device="cuda", graphs=graphed))
        (ie, le), (ig, lg) = finals["eager"], finals["graphed"]
        rec = dict(phase="graphs", run="job", optimizer=name,
                   steps=cfg.iters_num,
                   steps_per_s={k: v for k, v in rates.items()},
                   **{f"{k}_profile": v for k, v in profiles.items()},
                   final_bit_equal=bool(np.array_equal(ie, ig)
                                        and le == lg),
                   final_psnr_db=psnr(ig, ie),
                   final_loss_rel=float(abs(lg / le - 1.0)))
        emit(rec)
        RECORD.setdefault("graphs", []).append(rec)
        recs.append(rec)
        if not (rec["final_bit_equal"]
                or (rec["final_psnr_db"] > GRAPH_GATE["psnr_db"]
                    and rec["final_loss_rel"] <= GRAPH_GATE["loss_rtol"])):
            raise AssertionError(f"graphs job {name}: {rec}")
    return dict(LAUNCHES)  # ---- and ends here ----


def executor_pair(params):
    """Two jobs of two buckets (512x512 and 384x512 contents) at once
    through Executor (two at a time, as config.simultaneous_tasks_count
    sets), each against its solo graphed run. The solo runs go first, so
    the Executor's jobs find their graphs captured and replay them
    concurrently (`overlapped`: each job reported a chunk before the
    other's last)."""
    import numpy as np

    from artstyletransfer_tpu_torch import config as config_mod
    from artstyletransfer_tpu_torch.config import Config
    from artstyletransfer_tpu_torch.engine.transfer import (
        ContentStylePair, TransferJob)
    from artstyletransfer_tpu_torch.kernels import LAUNCHES, reset_launches
    from artstyletransfer_tpu_torch.runtime.executor import Executor

    cfg = Config(levels_num=2, base_diameter=256, iters_num=40,
                 stream_every=5, optimizer="adam")
    pairs = {}
    for i, tid in enumerate(("square", "wide")):
        content, style = synthetic_pair(seed=40 + i)
        if tid == "wide":
            content = content[64:448]
        pairs[tid] = (content, style)
    solo = {tid: list(TransferJob(c, s_img, cfg, params=params,
                                  device="cuda").run())[-1][1]
            for tid, (c, s_img) in pairs.items()}
    stamps = {tid: [] for tid in pairs}

    async def report(task_id, result):
        stamps[task_id].append((time.time(), result[0], result[1]))

    async def go():
        from functools import partial

        from artstyletransfer_tpu_torch.engine.transfer import (
            neural_style_transfer)

        ex = Executor(cfg, report_progress=report, verbose=False,
                      engine=partial(neural_style_transfer, params=params),
                      device="cuda")
        for tid, (c, s_img) in pairs.items():
            await ex.add_task(tid, ContentStylePair(("c", c), ("s", s_img)))
        await ex.run()
        if ex.failures:
            raise next(iter(ex.failures.values()))

    reset_launches()  # ---- this run of the path starts here ----
    asyncio.run(go())
    launches = dict(LAUNCHES)  # ---- and ends here ----
    a, b = stamps["square"], stamps["wide"]
    rec = dict(phase="graphs", run="executor",
               simultaneous_tasks=config_mod.simultaneous_tasks_count,
               overlapped=bool(a and b and a[0][0] < b[-1][0]
                               and b[0][0] < a[-1][0]))
    ok = True
    for tid in pairs:
        if not stamps[tid] or stamps[tid][-1][1] < 100.0:
            raise AssertionError(f"executor {tid} did not complete")
        img = stamps[tid][-1][2]
        rec[tid] = dict(shape=list(img.shape),
                        bit_equal=bool(np.array_equal(img, solo[tid])),
                        psnr_db=psnr(img, solo[tid]))
        ok = ok and (rec[tid]["bit_equal"]
                     or rec[tid]["psnr_db"] > GRAPH_GATE["psnr_db"])
    emit(rec)
    RECORD.setdefault("graphs", []).append(rec)
    if not ok:
        raise AssertionError(f"graphs executor: {rec}")
    return launches


def warmup_then_queue(params):
    """warmup_aspect_buckets over every DEFAULT_ASPECT_BUCKETS bucket at
    sizes 1, 2, 4, 8 (one step each) from an empty graph cache: graphs
    captured, seconds, seconds per capture, peak memory; then a padded
    queue round of the same config over three buckets (sizes 4, 1 and 2
    after padding), which must capture nothing."""
    import gc

    import numpy as np
    import torch

    from artstyletransfer_tpu_torch.config import Config
    from artstyletransfer_tpu_torch.engine import graphs, transfer
    from artstyletransfer_tpu_torch.engine.warmup import (
        warmup_aspect_buckets)
    from artstyletransfer_tpu_torch.kernels import LAUNCHES, reset_launches
    from artstyletransfer_tpu_torch.parallel import run_job_queue
    from artstyletransfer_tpu_torch.parallel.batch import (
        DEFAULT_ASPECT_BUCKETS)

    cfg = Config(levels_num=2, base_diameter=256, iters_num=4,
                 stream_every=2, optimizer="adam")
    sizes = (1, 2, 4, 8)
    transfer._COMPILE_CACHE.clear()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    paths = {}
    reset_launches()  # ---- this run of the path starts here ----
    t0 = time.time()
    n = warmup_aspect_buckets(cfg, params=params, verbose=False, steps=1,
                              batch_sizes=sizes, device="cuda")
    torch.cuda.synchronize()
    seconds = time.time() - t0
    paths["graphs_warmup"] = dict(LAUNCHES)  # ---- and ends here ----
    entries = [transfer._COMPILE_CACHE[k]
               for k in list(transfer._COMPILE_CACHE._d)]
    rec = dict(phase="graphs", run="warmup",
               buckets=len(DEFAULT_ASPECT_BUCKETS), sizes=list(sizes),
               graphs=n, cached=len(entries), seconds=seconds,
               capture_s=[e.capture_s for e in entries],
               mean_capture_s=float(np.mean([e.capture_s
                                             for e in entries])),
               base_mem_gb=base_gb,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               peak_reserved_gb=torch.cuda.max_memory_reserved() / 1e9)
    jobs = []
    for i, (h, w) in enumerate([(512, 512)] * 3 + [(384, 512), (600, 340),
                                                   (620, 350)]):
        content, style = synthetic_pair(seed=60 + i, size=max(h, w))
        jobs.append((f"q{i}", content[:h, :w], style))
    before = graphs.CAPTURES
    reset_launches()  # ---- this run of the path starts here ----
    results, failures = run_job_queue(jobs, cfg, params=params,
                                      canonicalize_contents=True,
                                      canonicalize_styles=True,
                                      pad_batches=True, device="cuda")
    torch.cuda.synchronize()
    paths["graphs_queue_after_warmup"] = dict(LAUNCHES)  # -- ends here --
    rec["queue_captures"] = graphs.CAPTURES - before
    rec["queue_shapes"] = sorted({tuple(img.shape) for img in
                                  results.values()})
    emit(rec)
    RECORD.setdefault("graphs", []).append(rec)
    if failures:
        raise next(iter(failures.values()))
    if not (n == len(DEFAULT_ASPECT_BUCKETS) * len(sizes)
            and rec["queue_captures"] == 0 and len(results) == len(jobs)
            and all(np.isfinite(img).all() for img in results.values())):
        raise AssertionError(f"graphs warmup: {rec}")
    return paths


def phase_graphs():
    """Graph replay against eager (see the module docstring)."""
    from artstyletransfer_tpu_torch.engine.transfer import TransferJob
    from artstyletransfer_tpu_torch.models.weights import init_vgg19_params
    from artstyletransfer_tpu_torch.parallel import BatchedTransferJob

    content, style = synthetic_pair()
    params = init_vgg19_params(seed=0)
    cfg = lbfgs_cfg()
    for lanes in (1, LANES):
        def make(graphed, lanes=lanes):
            if lanes == 1:
                return TransferJob(content, style, cfg, params=params,
                                   device="cuda", graphs=graphed)
            return BatchedTransferJob([content] * lanes, [style] * lanes,
                                      cfg, params=params, device="cuda",
                                      graphs=graphed)
        eval_check(f"lanes{lanes}", make(False), make(True), cfg)
    paths = {"graphs_job": job_runs(content, style, params),
             "graphs_executor": executor_pair(params)}
    paths.update(warmup_then_queue(params))
    for path, launches in paths.items():
        # Adam jobs, and L-BFGS jobs with their Grams recomputed
        check_launches(path, launches, card_step(cfg))
    return paths


ONLINE_ADAM = dict(levels_num=2, base_diameter=256, optimizer="adam",
                   iters_num=20, stream_every=5)
ONLINE_LBFGS = dict(levels_num=2, base_diameter=256, optimizer="lbfgs",
                    lbfgs_t_init="unit", lbfgs_grams="incremental",
                    iters_num=10, stream_every=2)


class LiveProbe:
    """Wraps LiveBatchRunner.step and ._rebuild for one session: the
    seconds, batch and job-steps of every chunk, and each rebuild's ms
    (with the ms of its BatchedTransferJob's construction: every lane's
    host pyramids and the targets) and device memory (allocated before
    and after, peak during; the peak counter is reset at each rebuild
    and each step)."""

    def __init__(self, iters):
        self.iters = iters
        self.steps, self.rebuilds, self.peaks = [], [], []
        self._done = {}  # tid -> steps reported so far

    def __enter__(self):
        import torch

        from artstyletransfer_tpu_torch.parallel import batch, live

        cls = live.LiveBatchRunner
        self._saved = (cls.step, cls._rebuild, batch.BatchedTransferJob)
        real_step, real_rebuild, real_batch = self._saved
        probe = self
        constructs = []

        class TimedBatch(real_batch):
            def __init__(self, *a, **kw):
                t0 = time.perf_counter()
                super().__init__(*a, **kw)
                torch.cuda.synchronize()
                constructs.append((time.perf_counter() - t0) * 1e3)

        def gb(fn):
            return fn() / 1e9

        def rebuild(runner, joins):
            torch.cuda.synchronize()
            before = (len(runner._lane_tid), gb(torch.cuda.memory_allocated))
            torch.cuda.reset_peak_memory_stats()
            constructs.clear()
            t0 = time.perf_counter()
            out = real_rebuild(runner, joins)
            torch.cuda.synchronize()
            probe.rebuilds.append(dict(
                ms=(time.perf_counter() - t0) * 1e3,
                construct_ms=sum(constructs), lanes_before=before[0],
                lanes_after=len(runner._lane_tid), joined=len(joins),
                alloc_before_gb=before[1],
                alloc_after_gb=gb(torch.cuda.memory_allocated),
                peak_gb=gb(torch.cuda.max_memory_allocated)))
            probe.peaks.append(probe.rebuilds[-1]["peak_gb"])
            return out

        def step(runner):
            n_rebuilds = len(probe.rebuilds)
            t0 = time.perf_counter()
            rep = real_step(runner)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            probe.peaks.append(gb(torch.cuda.max_memory_allocated))
            torch.cuda.reset_peak_memory_stats()
            job_steps = 0
            for tid, pct, _img, _loss in rep.progress:
                now = round(pct * probe.iters / 100.0)
                job_steps += now - probe._done.get(tid, 0)
                probe._done[tid] = now
            probe.steps.append(dict(
                s=seconds, batch=rep.batch, lanes=len(rep.progress),
                job_steps=job_steps,
                rebuilt=len(probe.rebuilds) > n_rebuilds))
            return rep

        cls.step, cls._rebuild = step, rebuild
        batch.BatchedTransferJob = TimedBatch
        return self

    def __exit__(self, *exc):
        from artstyletransfer_tpu_torch.parallel import batch, live

        (live.LiveBatchRunner.step, live.LiveBatchRunner._rebuild,
         batch.BatchedTransferJob) = self._saved

    def steady_rate(self, batch):
        """Job-steps/s of the chunks at `batch` lanes that rebuilt
        nothing."""
        sel = [r for r in self.steps if r["batch"] == batch
               and not r["rebuilt"]]
        secs = sum(r["s"] for r in sel)
        return sum(r["job_steps"] for r in sel) / secs if secs else None


class PlainSpy:
    """Counts calls of the kernels' plain versions while active."""

    NAMES = [("gram", "gram_plain"), ("gram", "gram_bwd_plain"),
             ("tv", "tv_plain"), ("tv", "tv_bwd_plain"),
             ("tv", "tv_sums_plain")]

    def __enter__(self):
        import importlib

        self.calls = {}
        self._saved = []
        for mod_name, fn in self.NAMES:
            mod = importlib.import_module(
                "artstyletransfer_tpu_torch.kernels." + mod_name)
            real = getattr(mod, fn)
            self._saved.append((mod, fn, real))

            def spy(*a, _real=real, _fn=fn, **kw):
                self.calls[_fn] = self.calls.get(_fn, 0) + 1
                return _real(*a, **kw)

            setattr(mod, fn, spy)
        return self

    def __exit__(self, *exc):
        for mod, fn, real in self._saved:
            setattr(mod, fn, real)


def online_session(cfg, first, later, params, wait_for=1,
                   canonicalize=True, mesh=None):
    """OnlineBatchingExecutor on the card: `first` jobs added at once,
    `later` once `wait_for` progress reports have arrived. Returns (the
    executor, {tid: seconds added -> first progress}, {tid: [(percent,
    loss)]}, {tid: final image}, session wall s)."""
    from artstyletransfer_tpu_torch.engine.transfer import ContentStylePair
    from artstyletransfer_tpu_torch.runtime.online import (
        OnlineBatchingExecutor)

    added, first_seen, losses, finals = {}, {}, {}, {}

    class Metrics:
        def log(self, event, task=None, percent=None, loss=None, **_kw):
            if event == "progress":
                first_seen.setdefault(task, time.perf_counter())
                losses.setdefault(task, []).append((percent, loss))

    async def report(tid, value):
        if value[0] >= 100.0:
            finals[tid] = value[1]

    async def go():
        ex = OnlineBatchingExecutor(cfg, params=params, verbose=False,
                                    metrics=Metrics(), report_progress=report,
                                    max_batch=16, canonicalize=canonicalize,
                                    mesh=mesh, device="cuda")
        for tid, c, s_img in first:
            added[tid] = time.perf_counter()
            await ex.add_task(tid, ContentStylePair(("c", c), ("s", s_img)))
        while sum(len(v) for v in losses.values()) < wait_for:
            await asyncio.sleep(0.001)
        for tid, c, s_img in later:
            added[tid] = time.perf_counter()
            await ex.add_task(tid, ContentStylePair(("c", c), ("s", s_img)))
        await ex.run()
        await ex.aclose()
        return ex

    t0 = time.perf_counter()
    ex = asyncio.run(go())
    wall = time.perf_counter() - t0
    if ex.failures:
        raise next(iter(ex.failures.values()))
    wait = {tid: first_seen[tid] - added[tid] for tid in added}
    return ex, wait, losses, finals, wall


def online_jobs():
    """Adam: 5 jobs with 512x512 contents and 1 with a 384x512 content;
    L-BFGS: 3 jobs with 512x512 contents; seeded synthetic images, the
    styles squared to the base diameter as the executor's canonicalizer
    does (so the solo check below sees the executor's inputs)."""
    adam = []
    for i in range(6):
        content, _ = synthetic_pair(seed=70 + i)
        _, style = synthetic_pair(seed=170 + i, size=256)
        if i == 5:
            content = content[64:448]
        adam.append((f"adam{i}", content, style))
    lbfgs = []
    for i in range(3):
        content, _ = synthetic_pair(seed=80 + i)
        _, style = synthetic_pair(seed=180 + i, size=256)
        lbfgs.append((f"lbfgs{i}", content, style))
    return adam, lbfgs


# the joined-against-alone check's jobs: B joins after A's second chunk
# and runs 2 steps beside A, then 4 alone
SOLO_CHECK = dict(iters_num=6, stream_every=2)


def solo_runs(content, style, cfg, params, n=2):
    """n TransferJob runs of one job: [(final image, final loss)]."""
    from artstyletransfer_tpu_torch.engine.transfer import TransferJob

    out = []
    for _ in range(n):
        job = TransferJob(content, style, cfg, params=params, device="cuda")
        _done, img, loss = list(job.run())[-1]
        out.append((img, float(loss)))
    return out


def online_solo_check(params, adam, lbfgs):
    """A job joined mid-flight against the same job run alone, at
    conv_precision='highest', for Adam and unit L-BFGS (6 steps, chunk
    2): job B (added, canonicalized already, once A's first chunk is
    reported) joins A's batch at A's next boundary and must run a chunk
    beside A; B alone is a TransferJob whose init noise has the seed the
    live runner gave B (cfg.seed + 1, its arrival). B alone runs twice,
    and the two runs must agree bit for bit: precision_gate runs cuDNN's
    deterministic algorithms at 'highest', and nothing here sets a torch
    flag. A control without joins: B as lane 1 of a 2-lane
    BatchedTransferJob from step 0. Held for Adam: PSNR > 50 dB and loss
    within rtol 1e-3 of B alone. Unit L-BFGS's line search branches on
    float32 comparisons, so a lane count's other summation order can send
    it another way: reported beside its control. Then two plain runs of
    the sessions' 20-step Adam job at 'highest' must agree bit for bit
    (held), and two at 'default' (TF32, where the gate leaves cuDNN's
    deterministic switch as it was) are reported."""
    import numpy as np
    import torch

    from artstyletransfer_tpu_torch.config import Config
    from artstyletransfer_tpu_torch.engine.init_pipeline import (
        build_init_image)
    from artstyletransfer_tpu_torch.parallel import BatchedTransferJob
    from artstyletransfer_tpu_torch.parallel.batch import (
        canonicalize_content, canonicalize_style)

    if torch.backends.cudnn.deterministic:
        raise AssertionError("cuDNN's deterministic switch is set outside "
                             "precision_gate")
    for name, kw, jobs in (("adam", ONLINE_ADAM, adam),
                           ("lbfgs_unit", ONLINE_LBFGS, lbfgs)):
        kw = dict(kw, **SOLO_CHECK)
        cfg = Config(conv_precision="highest", **kw)
        canon = [(canonicalize_content(c, cfg),
                  canonicalize_style(s_, cfg)) for _t, c, s_ in jobs[:2]]
        (ta, _ca, _sa), (tb, _cb, _sb) = jobs[:2]
        with LiveProbe(cfg.iters_num) as probe:
            _ex, _wait, losses, finals, _wall = online_session(
                cfg, [(ta,) + canon[0]], [(tb,) + canon[1]], params,
                canonicalize=False)
        beside = sum(r["lanes"] == 2 for r in probe.steps)
        runs = solo_runs(*canon[1], Config(conv_precision="highest",
                                           seed=cfg.seed + 1, **kw),
                         params)
        img, loss = runs[0]
        inits = [build_init_image(
            cfg.init_method, c, s_, cfg,
            rng=np.random.default_rng(cfg.seed + i))[0]
            for i, (c, s_) in enumerate(canon)]
        pair = BatchedTransferJob([c for c, _s in canon],
                                  [s_ for _c, s_ in canon], cfg,
                                  params=params, init_overrides=inits,
                                  device="cuda")
        _done, imgs, pair_losses = list(pair.run())[-1]
        joined_loss = losses[tb][-1][1]
        rec = dict(phase="online", run="joined_vs_solo", optimizer=name,
                   steps=cfg.iters_num, precision="highest",
                   determinism="precision_gate", chunks_beside_a=beside,
                   batches=[r["batch"] for r in probe.steps],
                   psnr_db=psnr(finals[tb], img),
                   bit_equal=bool(np.array_equal(finals[tb], img)),
                   joined_loss=joined_loss, solo_loss=loss,
                   loss_rel=abs(joined_loss / loss - 1.0),
                   solo_rerun_bit_equal=bool(
                       np.array_equal(runs[0][0], runs[1][0])
                       and runs[0][1] == runs[1][1]),
                   batched_lane_psnr_db=psnr(imgs[1], img),
                   batched_lane_loss_rel=abs(
                       float(pair_losses[1]) / loss - 1.0))
        emit(rec)
        RECORD.setdefault("online", []).append(rec)
        if not (rec["solo_rerun_bit_equal"] and beside
                and (name != "adam" or (rec["psnr_db"] > 50.0
                                        and rec["loss_rel"] <= 1e-3))):
            raise AssertionError(
                f"online: joined job against alone: {rec}")
    _t, c, s_ = adam[1]
    reruns = []
    for precision in ("highest", "default"):
        cfg = Config(conv_precision=precision, seed=1, **ONLINE_ADAM)
        (ia, la), (ib, lb) = solo_runs(canonicalize_content(c, cfg),
                                       canonicalize_style(s_, cfg), cfg,
                                       params)
        rec = dict(phase="online", run="solo_rerun", optimizer="adam",
                   steps=cfg.iters_num, precision=precision,
                   bit_equal=bool(np.array_equal(ia, ib) and la == lb),
                   psnr_db=psnr(ia, ib), loss_rel=abs(la / lb - 1.0))
        emit(rec)
        RECORD.setdefault("online", []).append(rec)
        reruns.append(rec)
    if not reruns[0]["bit_equal"]:
        raise AssertionError(f"online: two runs at 'highest' part: "
                             f"{reruns[0]}")


CONV_KERNEL_KEYS = ("conv", "cudnn", "xmma", "implicit", "winograd", "fft",
                    "fprop", "dgrad", "wgrad", "sm90_", "sm80_", "cutlass")


def _eval_device_ms(fn, reps):
    """(all kernels, convolution kernels) device ms per call of fn, from
    one torch.profiler session: cuDNN's kernels by their names (the port's
    own kernels and the elementwise ones are the rest)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = conv = 0.0
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = float(getattr(evt, "self_device_time_total",
                           getattr(evt, "self_cuda_time_total", 0)))
        total += us
        low = evt.key.lower()
        if any(k in low for k in CONV_KERNEL_KEYS) and not any(
                own in low for own in ("gram", "tv_fwd", "tv_bwd")):
            conv += us
    if total <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return total / 1e3 / reps, conv / 1e3 / reps


def deterministic_cost(params, reps=5):
    """What cuDNN's deterministic algorithms cost one eager loss-and-
    gradient evaluation of the main job (1 lane, 2 levels, 512 px), at
    'highest' (TF32 off) and at 'default' (TF32 on): device ms of the
    whole evaluation and of its convolutions, with the switch on and off,
    in the order on, off, off, on. The torch flags are set directly here,
    outside precision_gate, and restored after."""
    import torch

    from artstyletransfer_tpu_torch.config import Config
    from artstyletransfer_tpu_torch.engine.transfer import TransferJob

    content, style = synthetic_pair()
    cudnn = torch.backends.cudnn
    saved = (cudnn.allow_tf32, cudnn.deterministic)
    rows = []
    try:
        for precision, tf32 in (("highest", False), ("default", True)):
            cfg = Config(levels_num=2, base_diameter=256,
                         conv_precision=precision)
            job = TransferJob(content, style, cfg, params=params,
                              device="cuda", graphs=False)
            x = job._x0
            times = {True: [], False: []}
            for det in (True, False, False, True):
                cudnn.allow_tf32, cudnn.deterministic = tf32, det
                times[det].append(_eval_device_ms(
                    lambda: job._loss_grad(x), reps))
            row = dict(phase="online", run="deterministic_cost",
                       precision=precision, shape=[512, 512], lanes=1,
                       eval_ms_det=[t for t, _c in times[True]],
                       eval_ms_default_algos=[t for t, _c in times[False]],
                       conv_ms_det=[c for _t, c in times[True]],
                       conv_ms_default_algos=[c for _t, c in times[False]])
            row["conv_ms_added"] = (sum(row["conv_ms_det"])
                                    - sum(row["conv_ms_default_algos"])) / 2
            emit(row)
            RECORD.setdefault("online", []).append(row)
            rows.append(row)
    finally:
        cudnn.allow_tf32, cudnn.deterministic = saved
    return rows


def phase_online():
    """Live serving on the card (see the module docstring)."""
    import numpy as np
    import torch

    from artstyletransfer_tpu_torch.config import Config
    from artstyletransfer_tpu_torch.engine import graphs
    from artstyletransfer_tpu_torch.engine.pyramid import level_shape
    from artstyletransfer_tpu_torch.engine.warmup import (
        warmup_aspect_buckets)
    from artstyletransfer_tpu_torch.kernels import LAUNCHES, reset_launches
    from artstyletransfer_tpu_torch.models.weights import init_vgg19_params
    from artstyletransfer_tpu_torch.parallel import run_job_queue
    from artstyletransfer_tpu_torch.parallel.batch import (
        bucket_content_shape, canonicalize_content, canonicalize_style)

    params = init_vgg19_params(seed=0)
    adam_jobs, lbfgs_jobs = online_jobs()
    # (name, config, first jobs, later jobs, buckets, lanes they reach)
    sessions = [("adam", Config(**ONLINE_ADAM), adam_jobs[:3],
                 adam_jobs[3:], (1.0, 4 / 3), (1, 2, 4, 8)),
                ("lbfgs_unit", Config(**ONLINE_LBFGS), lbfgs_jobs[:2],
                 lbfgs_jobs[2:], (1.0,), (1, 2, 4))]
    t0 = time.time()
    warmed = sum(warmup_aspect_buckets(cfg, params=params, aspects=aspects,
                                       verbose=False, steps=1,
                                       batch_sizes=sizes, device="cuda")
                 for _name, cfg, _f, _l, aspects, sizes in sessions)
    torch.cuda.synchronize()
    warm_s = time.time() - t0
    captures = graphs.CAPTURES
    paths = {}
    for name, cfg, first, later, _aspects, _sizes in sessions:
        torch.cuda.reset_peak_memory_stats()
        reset_launches()  # ---- this run of the path starts here ----
        with LiveProbe(cfg.iters_num) as probe, PlainSpy() as plain:
            ex, wait, losses, finals, wall = online_session(
                cfg, first, later, params, wait_for=len(first))
            torch.cuda.synchronize()
        launches = dict(LAUNCHES)  # ---- and ends here ----
        paths[f"online_{name}"] = launches
        check_launches(f"online {name}", launches, card_step(cfg))
        jobs = first + later
        job_steps = len(jobs) * cfg.iters_num
        rec = dict(phase="online", run="session", optimizer=name,
                   jobs=len(jobs), joiners=[t for t, _c, _s in later],
                   steps=cfg.iters_num, wall_s=wall,
                   job_steps_per_s=job_steps / wall,
                   first_progress_s=wait,
                   newcomer_first_progress_s={t: wait[t]
                                              for t, _c, _s in later},
                   rebuilds=probe.rebuilds,
                   batches=[r["batch"] for r in probe.steps],
                   steady_job_steps_per_s={
                       str(b): probe.steady_rate(b)
                       for b in sorted({r["batch"] for r in probe.steps})},
                   peak_mem_gb=max(probe.peaks),
                   graphs_captured=graphs.CAPTURES - captures,
                   plain_calls=plain.calls, launches=launches,
                   losses={t: [v[0][1], v[-1][1]]
                           for t, v in losses.items()})
        if name == "adam":
            # run_job_queue on the same jobs, padded as online rounds pad
            canon = [(t, canonicalize_content(c, cfg),
                      canonicalize_style(s_img, cfg))
                     for t, c, s_img in jobs]
            events = []

            def progress(tid, pct, img, loss):
                events.append((time.time(), tid, pct, loss))

            tq = time.perf_counter()
            _res, fails = run_job_queue(canon, cfg, params=params,
                                        progress=progress, pad_batches=True,
                                        device="cuda")
            torch.cuda.synchronize()
            if fails:
                raise next(iter(fails.values()))
            rec["queue_wall_s"] = time.perf_counter() - tq
            rec["queue_job_steps_per_s"] = job_steps / rec["queue_wall_s"]
            rec["queue_chunk_rates"] = chunk_rates(canon, events, cfg)
        rec["final_shapes"] = {t: list(img.shape) for t, img in finals.items()}
        emit(rec)
        RECORD.setdefault("online", []).append(rec)
        for tid, c, _s in jobs:
            img = finals.get(tid)
            rep = [loss for _p, loss in losses.get(tid, [])]
            top = level_shape(*bucket_content_shape(c.shape[1] / c.shape[0],
                                                    cfg),
                              cfg.levels_num - 1, cfg.base_diameter) + (3,)
            if img is None or img.shape != top or not np.isfinite(img).all():
                raise AssertionError(f"online {name} {tid}: no final image "
                                     f"of shape {top}")
            if not (np.isfinite(rep).all() and rep[-1] < rep[0]):
                raise AssertionError(f"online {name} {tid}: losses {rep} "
                                     "are not finite and falling")
        if rec["graphs_captured"] or plain.calls:
            raise AssertionError(f"online {name}: captured "
                                 f"{rec['graphs_captured']} graphs, plain "
                                 f"calls {plain.calls}")
        captures = graphs.CAPTURES
    online_solo_check(params, adam_jobs, lbfgs_jobs)
    deterministic_cost(params)
    RECORD.setdefault("online", []).append(dict(warm_graphs=warmed,
                                                warm_s=warm_s))
    emit(dict(phase="online", run="warmup", graphs=warmed, seconds=warm_s))
    return paths


FRONTEND_DIR = os.path.join(ROOT, ".smoke_weights")  # gitignored; removed
# the bot session: Adam, so that the live path serves it
BOT_ADAM = dict(levels_num=2, base_diameter=256, optimizer="adam",
                iters_num=40, stream_every=5)
BOT_DEBOUNCE_S = 0.05  # the album debounce in the bot session (default 1 s)


@contextlib.contextmanager
def weights_from(pth, cache):
    """A block in which load_vgg19_params() resolves its weights as a
    deployment would: ASTT_VGG19_WEIGHTS names `pth`, and the weights
    cache is the file `cache`."""
    from artstyletransfer_tpu_torch.models import weights

    with mock.patch.object(weights, "_CACHE_DIR", os.path.dirname(cache)), \
            mock.patch.object(weights, "_CACHE_FILE", cache), \
            mock.patch.dict(os.environ, {"ASTT_VGG19_WEIGHTS": pth}):
        yield


def weights_file_check(directory):
    """The seeded weights (init_vgg19_params(seed=0)) written as a
    torchvision-layout .pth state dict (features.<idx>.weight/bias, OIHW)
    in `directory`, with the weights cache beside it. Holds that
    load_vgg19_params() under weights_from gives the seeded arrays bit for
    bit and writes the cache; returns (pth, cache)."""
    import numpy as np
    import torch

    from artstyletransfer_tpu_torch.models import weights

    params = weights.init_vgg19_params(seed=0)
    pth = os.path.join(directory, "vgg19.pth")
    torch.save({f"features.{idx}.{k}": torch.from_numpy(np.ascontiguousarray(
        np.transpose(params[name]["w"], (3, 2, 0, 1)) if k == "weight"
        else params[name]["b"]))
        for name, idx in weights._TORCHVISION_INDICES.items()
        for k in ("weight", "bias")}, pth)
    cache = os.path.join(directory, "cache", "vgg19_features.npz")
    with weights_from(pth, cache):
        loaded = weights.load_vgg19_params()
    same = all(np.array_equal(loaded[n][k], params[n][k])
               and loaded[n][k].dtype == params[n][k].dtype
               for n in params for k in ("w", "b"))
    rec = dict(phase="frontends", run="weights_file", file="vgg19.pth",
               layout="torchvision", bit_equal=bool(same),
               cached=os.path.exists(cache))
    emit(rec)
    RECORD.setdefault("frontends", []).append(rec)
    if not (same and rec["cached"]):
        raise AssertionError(f"frontends: weights from the .pth: {rec}")
    return pth, cache


def session_checks(name, finals, tops, losses):
    """Every final image finite and of its bucket's top-level shape (both
    keyed alike), and every task's losses finite and falling."""
    import numpy as np

    for key, top in tops.items():
        img = finals.get(key)
        if img is None or img.shape != top or not np.isfinite(img).all():
            raise AssertionError(f"frontends {name} {key}: no final image "
                                 f"of shape {top}")
    for tid, rep in losses.items():
        if not (len(rep) >= 2 and np.isfinite(rep).all()
                and rep[-1] < rep[0]):
            raise AssertionError(f"frontends {name} {tid}: losses {rep} "
                                 "are not finite and falling")


def top_shape(content, cfg):
    """The top-level image shape of a content's serving bucket."""
    from artstyletransfer_tpu_torch.engine.pyramid import level_shape
    from artstyletransfer_tpu_torch.parallel.batch import bucket_content_shape

    return level_shape(*bucket_content_shape(content.shape[1]
                                             / content.shape[0], cfg),
                       cfg.levels_num - 1, cfg.base_diameter) + (3,)


async def fetch_through_aiohttp(lab, cfg, tids):
    """GET / and /generated/<id> of the lab's tasks through the aiohttp
    app on a test server (same executor): the statuses and byte counts."""
    from aiohttp.test_utils import TestClient, TestServer

    from artstyletransfer_tpu_torch.frontends.lab import create_app

    app = create_app(config=cfg, data_dir=lab.data_dir, pairs=[],
                     autostart=False, executor=lab.executor, device="cuda")
    client = TestClient(TestServer(app))
    await client.start_server()
    try:
        index = await client.get("/")
        html = await index.text()
        out = dict(index_status=index.status,
                   index_cards=html.count('class="card'))
        images = [await client.get(f"/generated/{tid}") for tid in tids]
        out["generated_status"] = [r.status for r in images]
        out["generated_bytes"] = [len(await r.read()) for r in images]
    finally:
        await client.close()
    if out["index_status"] != 200 or out["index_cards"] != len(tids) \
            or set(out["generated_status"]) != {200}:
        raise AssertionError(f"frontends: the lab's aiohttp app: {out}")
    return out


def lab_session():
    """The lab's app-free core (frontends/lab.py Lab) with its default
    online executor on CUDA, the standard preset (production_config:
    2 levels, 512 px top level, full-width VGG19, the default L-BFGS with
    the lr opening, so the round path serves it) cut to 10 steps in
    chunks of 5; four demo pairs, three square and one 384x512."""
    import dataclasses
    import json

    import numpy as np
    import torch

    from artstyletransfer_tpu_torch.config import PRESETS, production_config
    from artstyletransfer_tpu_torch.engine import graphs
    from artstyletransfer_tpu_torch.frontends.lab import Lab
    from artstyletransfer_tpu_torch.utils.image import (decode_image,
                                                        save_image)

    cfg = dataclasses.replace(
        production_config(PRESETS["standard"], device="cuda"),
        iters_num=10, stream_every=5)
    data = FRONTEND_DIR
    for sub in ("content-images", "style-images"):
        os.makedirs(os.path.join(data, sub), exist_ok=True)
    pairs, contents = [], {}
    for i in range(4):
        content, _ = synthetic_pair(seed=300 + i)
        if i == 3:  # 384x512 at 512 px
            h = content.shape[0]
            content = content[h // 8:h - h // 8]
        _, style = synthetic_pair(seed=400 + i)
        c_name, s_name = f"c{i}.jpg", f"s{i}.jpg"
        save_image(content, os.path.join(data, "content-images", c_name))
        save_image(style, os.path.join(data, "style-images", s_name))
        pairs.append((c_name, s_name))
        contents[c_name] = content
    metrics_path = os.path.join(data, "lab_metrics.jsonl")

    async def go():
        lab = Lab(config=cfg, data_dir=data, pairs=pairs, online=True,
                  metrics_path=metrics_path, device="cuda")
        await lab.backend_task()
        deadline = time.time() + 300
        while True:
            cards = await lab.index_cards()
            if any(c["failed"] for c in cards):
                raise AssertionError(f"frontends lab: a failed card {cards}")
            if len(cards) == len(pairs) and all(c["percent"] >= 100
                                                for c in cards):
                break
            if time.time() > deadline:
                raise AssertionError(f"frontends lab: cards {cards}")
            await asyncio.sleep(0.005)
        tids = [c["image_id"] for c in cards]
        served = {t: decode_image(await lab.latest_jpeg(t)) for t in tids}
        finals = {t: (await lab.executor.get_progress(t))[1] for t in tids}
        http = await fetch_through_aiohttp(lab, cfg, tids)
        await lab.aclose()
        return lab, cards, served, finals, http

    torch.cuda.reset_peak_memory_stats()
    captures = graphs.CAPTURES
    t0 = time.time()
    lab, cards, served, finals, http = asyncio.run(go())
    torch.cuda.synchronize()
    wall = time.time() - t0
    with open(metrics_path) as fh:
        events = [json.loads(line) for line in fh]
    added = {e["task"]: e["t"] for e in events if e["event"] == "task_added"}
    progress = {}
    for e in events:
        if e["event"] == "progress":
            progress.setdefault(e["task"], []).append((e["t"], e["loss"]))
    tids = [c["image_id"] for c in cards]
    order = dict(zip(sorted(added, key=added.get), pairs))
    rec = dict(phase="frontends", run="lab",
               preset="standard", optimizer=cfg.optimizer,
               lbfgs_t_init=cfg.lbfgs_t_init, steps=cfg.iters_num,
               stream_every=cfg.stream_every, requests=len(tids),
               first_progress_s={t: progress[t][0][0] - added[t]
                                 for t in tids},
               done_s={t: progress[t][-1][0] - added[t] for t in tids},
               contents={t: list(contents[order[t][0]].shape[:2])
                         for t in tids},
               session_wall_s=wall,
               job_steps_per_s=len(tids) * cfg.iters_num / (
                   max(p[-1][0] for p in progress.values())
                   - min(added.values())),
               dispatch_rounds=lab.executor.dispatch_rounds,
               graphs_captured=graphs.CAPTURES - captures,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               served_shapes={t: list(v.shape) for t, v in served.items()},
               losses={t: [l for _t, l in progress[t]] for t in tids},
               aiohttp=http)
    tops = {t: top_shape(contents[order[t][0]], cfg) for t in tids}
    session_checks("lab", finals, tops, rec["losses"])
    for t in tids:
        if served[t].shape != tops[t] or not np.isfinite(served[t]).all():
            raise AssertionError(f"frontends lab {t}: served image "
                                 f"{served[t].shape}, want {tops[t]}")
    return rec


class FakeBotClient:
    """The bot's transport in-process (no network): scripted getUpdates
    (two albums, then a third once the first progress photo was sent),
    files from memory, and a record of every message and photo with its
    time."""

    def __init__(self, albums, deadline_s=300.0):
        from artstyletransfer_tpu_torch.utils.image import encode_jpeg

        self.files, self.batches = {}, []
        for chat, (content, style) in albums.items():
            group = []
            for part, img in (("c", content), ("s", style)):
                fid = f"{chat}{part}"
                self.files[fid] = encode_jpeg(img, quality=95)
                group.append({"chat": {"id": chat},
                              "media_group_id": f"album{chat}",
                              "photo": [{"file_id": fid}]})
            self.batches.append(group)
        self.messages, self.photos, self.delivered = [], [], {}
        self.deadline = time.perf_counter() + deadline_s
        self.calls = 0
        self.timed_out = False

    async def send_message(self, chat_id, text):
        self.messages.append((chat_id, text, time.perf_counter()))

    async def send_photo(self, chat_id, data, caption, filename=None):
        from artstyletransfer_tpu_torch.utils.image import decode_image

        self.photos.append((chat_id, caption, time.perf_counter(),
                            decode_image(data)))

    async def download_file(self, file_id):
        return self.files[file_id]

    async def _until(self, cond):
        while not cond():
            if time.perf_counter() > self.deadline:
                self.timed_out = True
                raise asyncio.CancelledError  # ends the polling loop
            await asyncio.sleep(0.002)

    def _updates(self, groups):
        now = time.perf_counter()
        out = []
        for group in groups:
            self.delivered[group[0]["chat"]["id"]] = now
            for msg in group:
                self.calls += 1
                out.append({"update_id": self.calls, "message": msg})
        return out

    async def get_updates(self, offset, timeout=30):
        if len(self.delivered) == 0:  # the first two albums at once
            return self._updates(self.batches[:2])
        if len(self.delivered) == 2:  # the third after the first photo
            await self._until(lambda: self.photos)
            return self._updates(self.batches[2:])
        n = len(self.batches)
        await self._until(lambda: sum(c == "Done!" for _ch, c, *_r
                                      in self.photos) >= n or any(
            "went wrong" in m for _ch, m, _t in self.messages))
        raise asyncio.CancelledError  # every album answered: stop polling


def bot_session():
    """StyleTransferBot on CUDA with the fake transport, online batching
    on and an Adam config (2 levels, 512 px, 40 steps in chunks of 5),
    after warmup_serving of the square bucket (the bot's --warmup, on
    CUDA): the live path serves three albums, the third arriving once the
    first progress photo was sent."""
    import torch

    from artstyletransfer_tpu_torch.config import Config, production_config
    from artstyletransfer_tpu_torch.engine import graphs
    from artstyletransfer_tpu_torch.engine.warmup import warmup_serving
    from artstyletransfer_tpu_torch.frontends import tlbot

    cfg = production_config(Config(**BOT_ADAM), device="cuda")
    t0 = time.time()
    warmed = warmup_serving(cfg, online=True, aspects=(1.0,), device="cuda")
    torch.cuda.synchronize()
    warm_s = time.time() - t0
    albums = {}
    for chat in (1, 2, 3):
        content, _ = synthetic_pair(seed=500 + chat)
        _, style = synthetic_pair(seed=600 + chat)
        albums[chat] = (content, style)
    client = FakeBotClient(albums)
    losses, joined = {}, {}

    class Metrics:
        def log(self, event, task=None, percent=None, loss=None, **kw):
            if event == "progress":
                losses.setdefault(task, []).append(loss)
            elif event == "task_joined":
                joined.setdefault(task, kw.get("batch"))

    async def go():
        bot = tlbot.StyleTransferBot(client, cfg, metrics=Metrics(),
                                     online=True, device="cuda")
        try:
            await bot.run_polling()
        except asyncio.CancelledError:
            pass
        await bot.executor.aclose()
        return bot

    torch.cuda.reset_peak_memory_stats()
    captures = graphs.CAPTURES
    t1 = time.time()
    with mock.patch.object(tlbot, "MEDIA_GROUP_DEBOUNCE_S", BOT_DEBOUNCE_S):
        bot = asyncio.run(go())
    torch.cuda.synchronize()
    wall = time.time() - t1
    transcript = {}
    for chat in albums:
        msgs = [m for ch, m, _t in client.messages if ch == chat]
        caps = [c for ch, c, *_r in client.photos if ch == chat]
        times = [t for ch, _c, t, _i in client.photos if ch == chat]
        transcript[chat] = dict(
            messages=msgs, captions=caps,
            first_photo_s=(times[0] - client.delivered[chat]
                           if times else None),
            done_s=(times[-1] - client.delivered[chat]
                    if caps and caps[-1] == "Done!" else None))
    rec = dict(phase="frontends", run="bot",
               optimizer=cfg.optimizer, steps=cfg.iters_num,
               stream_every=cfg.stream_every, debounce_s=BOT_DEBOUNCE_S,
               warmup_graphs=warmed, warmup_s=warm_s,
               albums=transcript, session_wall_s=wall,
               joined_batch=joined,
               graphs_captured=graphs.CAPTURES - captures,
               dispatch_rounds=bot.executor.dispatch_rounds,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               losses={t: [v[0], v[-1]] for t, v in losses.items()},
               timed_out=client.timed_out)
    for chat, t in transcript.items():
        progress_caps = [c for c in t["captions"] if c.startswith("Progress")]
        if (t["messages"].count("Processing has started. Please, wait...")
                != 1 or t["captions"].count("Done!") != 1
                or t["captions"][-1] != "Done!" or not progress_caps
                or any("went wrong" in m for m in t["messages"])):
            raise AssertionError(f"frontends bot: chat {chat}: {t}")
    if client.timed_out or bot.tasks_table or bot.executor.failures:
        raise AssertionError(f"frontends bot: {rec}")
    finals = {chat: next(i for ch, c, _t, i in client.photos
                         if ch == chat and c == "Done!") for chat in albums}
    tops = {chat: top_shape(albums[chat][0], cfg) for chat in albums}
    if len(losses) != len(albums):
        raise AssertionError(f"frontends bot: losses of {len(losses)} "
                             f"tasks for {len(albums)} albums")
    session_checks("bot", finals, tops, losses)
    return rec


def phase_frontends():
    """The lab and the bot on the card (see the module docstring)."""
    import shutil

    import aiohttp
    import cv2
    import jinja2
    import torch

    from artstyletransfer_tpu_torch.config import (PRESETS, Config,
                                                   production_config)
    from artstyletransfer_tpu_torch.kernels import LAUNCHES, reset_launches

    # the forms of lab_session's and bot_session's jobs
    cfgs = {"lab": production_config(PRESETS["standard"], device="cuda"),
            "bot": production_config(Config(**BOT_ADAM), device="cuda")}
    rec = dict(phase="frontends", run="environment",
               python=sys.version.split()[0], torch=torch.__version__,
               cuda=torch.version.cuda,
               **{m.__name__: getattr(m, "__version__", None)
                  for m in (aiohttp, cv2, jinja2)})
    emit(rec)
    RECORD.setdefault("frontends", []).append(rec)
    paths = {}
    os.makedirs(FRONTEND_DIR, exist_ok=True)
    try:
        pth, cache = weights_file_check(FRONTEND_DIR)
        with weights_from(pth, cache):
            for name, session in (("lab", lab_session), ("bot", bot_session)):
                reset_launches()  # ---- this run of the path starts here ----
                with PlainSpy() as plain:
                    rec = session()
                launches = dict(LAUNCHES)  # ---- and ends here ----
                paths[f"frontends_{name}"] = launches
                rec.update(launches=launches, plain_calls=plain.calls)
                emit(rec)
                RECORD.setdefault("frontends", []).append(rec)
                check_launches(f"frontends {name}", launches,
                               card_step(cfgs[name]))
                if plain.calls:
                    raise AssertionError(f"frontends {name}: plain calls "
                                         f"{plain.calls}")
    finally:
        shutil.rmtree(FRONTEND_DIR, ignore_errors=True)
    return paths


LARGE = dict(levels_num=4, base_diameter=256, optimizer="adam",
             iters_num=10, stream_every=5)
LARGE_LIMIT = 70e9  # bytes: a batch runs when memory_stats predicts below
# kernel launches of one evaluation without remat: 5 style layers, one
# TV image and 13 convs' glue each way per level, 4 levels; remat runs
# each forward kernel twice
LARGE_EVAL = {"gram": 20, "gram_bwd": 20, "tv": 4, "tv_bwd": 4,
              "conv_relu": 0, "vgg_glue": 52, "vgg_glue_bwd": 52}
REMAT_EVAL = {"gram": 40, "gram_bwd": 20, "tv": 8, "tv_bwd": 4,
              "conv_relu": 0, "vgg_glue": 104, "vgg_glue_bwd": 52}
_LARGE = {}  # the large phase's seeded images, made once


def free_card():
    """Drop every cached graph and return the allocator's free memory, so
    that a large run's peak is its own."""
    import gc

    import torch

    from artstyletransfer_tpu_torch.engine import transfer

    transfer._COMPILE_CACHE.clear()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def large_inputs(lanes, cfg):
    """`lanes` seeded 2048 px contents, one style, and each lane's init
    image (seed cfg.seed + lane, as BatchedTransferJob seeds it), made
    once per lane; returns them and the seconds each init took."""
    import numpy as np

    from artstyletransfer_tpu_torch.engine.init_pipeline import (
        build_init_image)

    if not _LARGE:
        _LARGE["style"] = synthetic_pair(seed=200, size=LARGE_HW)[1]
        _LARGE["lanes"] = []
    style = _LARGE["style"]
    while len(_LARGE["lanes"]) < lanes:
        i = len(_LARGE["lanes"])
        content = synthetic_pair(seed=300 + i, size=LARGE_HW)[0]
        t0 = time.perf_counter()
        init, _ = build_init_image(cfg.init_method, content, style, cfg,
                                   rng=np.random.default_rng(cfg.seed + i))
        _LARGE["lanes"].append((content, init, time.perf_counter() - t0))
    got = _LARGE["lanes"][:lanes]
    return ([c for c, _, _ in got], style, [i for _, i, _ in got],
            [t for _, _, t in got])


def gb(n):
    return None if n is None else n / 1e9


def run_large(name, cfg, lanes, params, expected_peak=None):
    """Unless expected_peak, a peak extrapolated from runs of fewer
    lanes, is above LARGE_LIMIT: memory_stats' prediction (and, when it
    is below LARGE_LIMIT, its measured peak), then a BatchedTransferJob of
    `lanes` lanes at 2048 px run graphed for cfg.iters_num steps, with the
    counters zeroed just before and read just after. Returns (record,
    launches, final images, final losses), or (record, None, None, None)
    for an extrapolation or a prediction alone."""
    import numpy as np
    import torch

    from artstyletransfer_tpu_torch.config import precision_gate
    from artstyletransfer_tpu_torch.kernels import LAUNCHES, reset_launches
    from artstyletransfer_tpu_torch.parallel import BatchedTransferJob
    from artstyletransfer_tpu_torch.parallel.memory import memory_stats

    if expected_peak is not None and expected_peak > LARGE_LIMIT:
        # the extrapolation alone (memory_stats' count of a batch this
        # large takes ~8 s and decides nothing)
        rec = dict(phase="large", run=name, lanes=lanes,
                   remat=cfg.remat_levels, precision=cfg.conv_precision,
                   expected_peak_gb=gb(expected_peak),
                   not_run=f"extrapolated peak above {gb(LARGE_LIMIT)} GB")
        emit(rec)
        RECORD.setdefault("large", []).append(rec)
        return rec, None, None, None
    free_card()
    t0 = time.perf_counter()
    stats = memory_stats(cfg, (LARGE_HW, LARGE_HW), lanes, device="cuda",
                         limit_bytes=LARGE_LIMIT)
    rec = dict(phase="large", run=name, lanes=lanes,
               remat=cfg.remat_levels, precision=cfg.conv_precision,
               expected_peak_gb=gb(expected_peak),
               predicted_gb=gb(stats["predicted_bytes"]),
               argument_gb=gb(stats["argument_bytes"]),
               saved_activation_gb=gb(stats["saved_activation_bytes"]),
               recompute_peak_gb=gb(stats["recompute_peak_bytes"]),
               stats_peak_gb=gb(stats["peak_bytes"]),
               stats_before_gb=gb(stats.get("allocated_before_bytes")),
               stats_s=time.perf_counter() - t0)
    if stats["peak_bytes"] is None:
        rec["not_run"] = f"predicted above {gb(LARGE_LIMIT)} GB"
        emit(rec)
        RECORD.setdefault("large", []).append(rec)
        return rec, None, None, None
    free_card()
    contents, style, inits, init_s = large_inputs(lanes, cfg)
    t0 = time.perf_counter()
    job = BatchedTransferJob(contents, [style] * lanes, cfg, params=params,
                             device="cuda", init_overrides=inits)
    torch.cuda.synchronize()
    construct_s = time.perf_counter() - t0
    first = job.initial_losses()
    torch.cuda.reset_peak_memory_stats()
    stamps = []
    with adam_step_events() as events:
        reset_launches()  # ---- this run of the path starts here ----
        t0 = time.perf_counter()
        for done, imgs, losses in job.run(yield_images=False):
            torch.cuda.synchronize()
            stamps.append((time.perf_counter() - t0, done))
        launches = dict(LAUNCHES)  # ---- and ends here ----
    peak = torch.cuda.max_memory_allocated()
    with precision_gate(cfg.conv_precision):
        reset_launches()
        job._loss_grad(job._x0)
        torch.cuda.synchronize()
        per_eval = {k: v for k, v in LAUNCHES.items()
                    if k not in CARD_STEP_ONLY}  # the evaluation's kernels
    # device ms per step after the first chunk (which captures), from
    # the start of its first step to the end of its last
    warm = events[cfg.stream_every:]
    rec.update(construct_s=construct_s, init_s_per_lane=init_s,
               capture_s=job._loss_grad._graph.capture_s,
               first_chunk_s=stamps[0][0], wall_s=stamps[-1][0],
               ms_per_step=(warm[0][0].elapsed_time(warm[-1][1]) / len(warm)
                            if warm else None),
               run_peak_gb=gb(peak),
               run_reserved_peak_gb=gb(torch.cuda.max_memory_reserved()),
               launches=launches,
               launches_per_eval=per_eval,
               first_loss=first.tolist(), last_loss=losses.tolist())
    emit(rec)
    RECORD.setdefault("large", []).append(rec)
    want = REMAT_EVAL if cfg.remat_levels else LARGE_EVAL
    if per_eval != want:
        raise AssertionError(f"large {name}: launches per evaluation "
                             f"{per_eval}, expected {want}")
    if (imgs.shape != (lanes, LARGE_HW, LARGE_HW, 3)
            or not np.isfinite(imgs).all()
            or not (np.isfinite(losses).all() and (losses < first).all())):
        raise AssertionError(f"large {name}: bad result {rec}")
    check_launches(f"large {name}", launches, card_step(cfg))
    return rec, launches, imgs, losses


def same_or_close(name, a, b):
    """Remat on against off: bit-equal arrays, else within rtol 1e-5 (the
    JAX package's tests/test_misc.py) with the difference printed."""
    import numpy as np

    out = {}
    for what, x, y in (("images", a[0], b[0]), ("losses", a[1], b[1])):
        equal = bool(np.array_equal(x, y))
        rel = float(np.abs(x - y).max() / max(np.abs(y).max(), 1e-30))
        out[what] = dict(bit_equal=equal, max_rel_diff=rel)
        if not equal and rel > 1e-5:
            raise AssertionError(f"{name}: remat on and off part, {what} "
                                 f"max relative difference {rel:.3e}")
    return out


def phase_large():
    """The 4-level 2048 px job with remat_levels off and on (see the
    module docstring)."""
    import dataclasses

    from artstyletransfer_tpu_torch.config import Config
    from artstyletransfer_tpu_torch.models.weights import init_vgg19_params

    params = init_vgg19_params(seed=0)
    base = Config(**LARGE)
    paths = {}
    peaks = {}  # (remat, lanes) -> the run's measured peak bytes
    for precision, lane_counts, steps in (("default", (1, 4), 10),
                                          ("highest", (1,), 3)):
        for lanes in lane_counts:
            finals = {}
            for remat in (False, True):
                cfg = dataclasses.replace(
                    base, remat_levels=remat, conv_precision=precision,
                    iters_num=steps, stream_every=min(5, steps))
                name = (f"{lanes}lane_{'remat' if remat else 'plain'}"
                        f"_{precision}")
                rec, launches, imgs, losses = run_large(name, cfg, lanes,
                                                        params)
                paths[f"large_{name}"] = launches
                finals[remat] = (imgs, losses)
                if precision == "default":
                    peaks[(remat, lanes)] = rec["run_peak_gb"] * 1e9
            rec = dict(phase="large", run=f"{lanes}lane_{precision}_remat_"
                       "against_plain",
                       **same_or_close(f"large {lanes} lanes {precision}",
                                       finals[True], finals[False]))
            emit(rec)
            RECORD.setdefault("large", []).append(rec)
    for remat in (True, False):
        # the peak grows linearly with the lanes: extrapolate 1 and 4
        one, four = peaks[(remat, 1)], peaks[(remat, 4)]
        cfg = dataclasses.replace(base, remat_levels=remat)
        name = f"8lane_{'remat' if remat else 'plain'}_default"
        _rec, launches, _imgs, _losses = run_large(
            name, cfg, 8, params, expected_peak=one + 7 * (four - one) / 3)
        if launches is not None:
            paths[f"large_{name}"] = launches

    paths["large_lbfgs"] = large_lbfgs(params)
    free_card()
    return paths


def large_lbfgs(params):
    """The benchmark cell lbfgs2k-solo's form of one job, 3 steps:
    production_config(Config(levels_num=4)) (strong-Wolfe L-BFGS opened at
    lr, a 100-pair float32 history, carried Grams, no remat) at 2048 px,
    which steps on the card; its history GB beside the card's budget for
    it (no warning may fire) and the run's peaks, and the evaluation's
    bytes a top-level value that the reserved peak holds beside the
    history (what engine/transfer.py's EVAL_BYTES_PER_TOP_VALUE holds,
    read from the served job); the counters zeroed just before and read
    just after."""
    import dataclasses

    import numpy as np
    import torch

    from artstyletransfer_tpu_torch.config import Config, production_config
    from artstyletransfer_tpu_torch.engine.transfer import (
        EVAL_BYTES_PER_TOP_VALUE, TransferJob, lbfgs_history_budget_gb,
        lbfgs_history_gb)
    from artstyletransfer_tpu_torch.kernels import LAUNCHES, reset_launches

    free_card()
    cfg = production_config(dataclasses.replace(
        Config(levels_num=LARGE["levels_num"],
               base_diameter=LARGE["base_diameter"]),
        iters_num=3, stream_every=3), "cuda")
    contents, style, inits, _ = large_inputs(1, cfg)
    job = TransferJob(contents[0], style, cfg, params=params, device="cuda",
                      init_override=inits[0])
    first = job.initial_loss()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()  # ---- this run of the path starts here ----
    t0 = time.perf_counter()
    done, img, loss = list(job.run())[-1]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)  # ---- and ends here ----
    hist = lbfgs_history_gb(cfg, job.level_shapes)
    budget = lbfgs_history_budget_gb(job.level_shapes, device="cuda")
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.max_memory_reserved()
    values = int(np.prod(job.level_shapes[0]))
    rec = dict(phase="large", run="1lane_lbfgs_lr_incremental_history100",
               lbfgs_grams=cfg.lbfgs_grams, t_init=cfg.lbfgs_t_init,
               history=cfg.lbfgs_history, remat=cfg.remat_levels, steps=done,
               wall_s=wall, history_gb=hist, history_budget_gb=budget,
               history_warning=hist > budget, run_peak_gb=gb(peak),
               run_reserved_peak_gb=gb(reserved),
               eval_bytes_per_top_value=(reserved - hist * 1e9) / values,
               eval_bytes_per_top_value_assumed=EVAL_BYTES_PER_TOP_VALUE,
               first_loss=first, last_loss=loss, launches=launches)
    emit(rec)
    RECORD.setdefault("large", []).append(rec)
    if (img.shape != (LARGE_HW, LARGE_HW, 3) or not loss < first
            or hist > budget):
        raise AssertionError(f"large lbfgs: bad result {rec}")
    check_launches("large lbfgs", launches, card_step(cfg))
    return launches


@contextlib.contextmanager
def adam_step_events():
    """CUDA events recorded on the current stream just before and just
    after every Adam step while active: yields the list of (start, end)
    pairs it fills."""
    import torch

    from artstyletransfer_tpu_torch.engine import transfer

    events = []
    real_step = transfer._Adam.step

    def step(self, x, s):
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real_step(self, x, s)
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        events.append((start, end))
        return out

    with mock.patch.object(transfer._Adam, "step", step):
        yield events


def lookahead_run(cfg, content, style, params, init=None):
    """One Adam TransferJob, graphed (captured before the run), with
    device events around every step, and the counters zeroed just before
    the run and read just after: (yields, record of the time to the first
    and last yield and the device's idle ms at each chunk boundary and,
    for comparison, between steps inside a chunk)."""
    import numpy as np
    import torch

    from artstyletransfer_tpu_torch.config import precision_gate
    from artstyletransfer_tpu_torch.engine import transfer
    from artstyletransfer_tpu_torch.kernels import LAUNCHES, reset_launches

    job = transfer.TransferJob(content, style, cfg, params=params,
                               device="cuda", init_override=init)
    with precision_gate(cfg.conv_precision):
        job._loss_grad(job._x0)  # the capture, before the timed run
    torch.cuda.synchronize()
    out = []
    with adam_step_events() as events:
        reset_launches()  # ---- this run of the path starts here ----
        t0 = time.perf_counter()
        for done, img, loss in job.run():
            out.append((time.perf_counter() - t0, done, img, loss))
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)  # ---- and ends here ----
    gaps = [events[i][1].elapsed_time(events[i + 1][0])
            for i in range(len(events) - 1)]
    chunk = cfg.stream_every
    boundary = [g for i, g in enumerate(gaps) if (i + 1) % chunk == 0]
    inner = [g for i, g in enumerate(gaps) if (i + 1) % chunk]
    step_ms = [a.elapsed_time(b) for a, b in events]
    return out, dict(first_yield_s=out[0][0], last_yield_s=out[-1][0],
                     boundary_idle_ms=boundary,
                     inner_idle_ms_mean=float(np.mean(inner)),
                     step_device_ms_mean=float(np.mean(step_ms)),
                     launches=launches)


def phase_lookahead():
    """pipeline_streaming on and off: a 2048 px 4-level Adam job and a 512
    px 2-level one, 20 steps in chunks of 5 (see the module docstring)."""
    import dataclasses

    import numpy as np

    from artstyletransfer_tpu_torch.config import Config
    from artstyletransfer_tpu_torch.models.weights import init_vgg19_params

    params = init_vgg19_params(seed=0)
    contents, style, inits, _ = large_inputs(1, Config(**LARGE))
    cases = [("2048px", dict(LARGE), (contents[0], style), inits[0]),
             ("512px", dict(levels_num=2, base_diameter=256,
                            optimizer="adam"), synthetic_pair(seed=5), None)]
    paths = {}
    for name, kw, (content, style), init in cases:
        cfg = Config(**dict(kw, iters_num=20, stream_every=5))
        free_card()
        runs = {}
        for pipe in (True, False, True, False):
            out, rec = lookahead_run(
                dataclasses.replace(cfg, pipeline_streaming=pipe),
                content, style, params, init)
            rec = dict(phase="lookahead", run=name, pipeline_streaming=pipe,
                       **rec)
            emit(rec)
            RECORD.setdefault("lookahead", []).append(rec)
            check_launches(f"lookahead {name}", rec["launches"],
                           card_step(cfg))
            paths.setdefault(f"lookahead_{name}_{'on' if pipe else 'off'}",
                             rec["launches"])
            runs.setdefault(pipe, out)
        same = all(a[1] == b[1] and a[3] == b[3]
                   and np.array_equal(a[2], b[2])
                   for a, b in zip(runs[True], runs[False]))
        if not same or len(runs[True]) != len(runs[False]):
            raise AssertionError(f"lookahead {name}: the yields with "
                                 "pipeline_streaming on and off differ")
    free_card()
    return paths


def phase_builders():
    """engine/builders.py's LossBuilder at 512 px against a one-level
    engine loss at the same image, on the card (see the module
    docstring)."""
    import numpy as np
    import torch

    from artstyletransfer_tpu_torch.config import Config, precision_gate
    from artstyletransfer_tpu_torch.engine.builders import LossBuilder
    from artstyletransfer_tpu_torch.engine.pyramid import (
        build_input_pyramids)
    from artstyletransfer_tpu_torch.engine.transfer import TransferJob
    from artstyletransfer_tpu_torch.kernels import LAUNCHES, reset_launches
    from artstyletransfer_tpu_torch.models.vgg19 import (CONTENT_INDEX,
                                                         STYLE_INDICES)
    from artstyletransfer_tpu_torch.models.weights import init_vgg19_params
    from artstyletransfer_tpu_torch.utils.image import prepare_img

    content, style = synthetic_pair(seed=9)
    params = init_vgg19_params(seed=0)
    cfg = Config(levels_num=1, base_diameter=512)
    job = TransferJob(content, style, cfg, params=params, device="cuda")
    c_lvls, s_lvls = build_input_pyramids(content, style, 1, 512)
    probe = c_lvls[0] * 0.7 + 0.1
    ref_total, ((_lt, lc, ls, ltv),) = job.loss_report(probe)

    def dev(img):
        return torch.from_numpy(prepare_img(img)).to(job.device)

    reset_launches()  # ---- the builders' path starts here ----
    with PlainSpy() as plain, precision_gate(cfg.conv_precision):
        lb = LossBuilder(CONTENT_INDEX, list(STYLE_INDICES), dev(c_lvls[0]),
                         dev(s_lvls[0]), job.params, cfg.content_weight,
                         cfg.style_weight, cfg.tv_weight)
        x = dev(probe).requires_grad_(True)
        out = lb.build(x)
        out[0].backward()
        torch.cuda.synchronize()
    launches = dict(LAUNCHES)  # ---- and ends here ----
    ours = [float(v.detach()) for v in out]
    ref = [ref_total, lc, ls, ltv]
    rel = [abs(a - b) / abs(b) for a, b in zip(ours, ref)]
    rec = dict(phase="builders", losses=ours, engine_losses=ref,
               rel_diff=rel, grad_finite=bool(torch.isfinite(x.grad).all()),
               launches=launches, plain_calls=plain.calls)
    emit(rec)
    RECORD["builders"] = rec
    if max(rel) > 1e-5 or not rec["grad_finite"]:
        raise AssertionError(f"builders: {rec}")
    if plain.calls or not all(launches[k] > 0
                              for k in ("gram", "gram_bwd", "tv")):
        raise AssertionError(f"builders: launches {launches}, plain calls "
                             f"{plain.calls}")
    if not np.isfinite(ours).all():
        raise AssertionError(f"builders: {rec}")
    return {"builders": launches}


MESH_ADAM = dict(levels_num=2, base_diameter=256, optimizer="adam",
                 iters_num=20, stream_every=5, conv_precision="highest")
MESH_LBFGS = dict(levels_num=2, base_diameter=256, optimizer="lbfgs",
                  lbfgs_t_init="unit", iters_num=8, stream_every=2,
                  stop_tol=1e-4, stop_shrink=True)
MESH_GATE = dict(psnr_db=50.0, loss_rtol=1e-3)  # PERF.md §2's queue gate
ON_EVERY_CARD = ("gram", "gram_bwd", "tv", "tv_bwd")


def per_card(mesh, counts, path):
    """The launches of each card of the mesh on a path; every card must
    show the Gram and TV kernels both ways."""
    out = {}
    for dev in dict.fromkeys(mesh.jobs_devices()):
        c = counts.get(dev.index, {})
        out[str(dev)] = {k: c.get(k, 0)
                         for k in ON_EVERY_CARD + ("conv_relu",)}
        missing = [k for k in ON_EVERY_CARD if not c.get(k)]
        if missing:
            raise AssertionError(f"mesh {path}: {dev} launched none of "
                                 f"{missing} ({c})")
    return out


def timed_queue(jobs, cfg, params, mesh):
    """run_job_queue on the mesh (or none) twice: the first run captures
    the graphs of its lane counts, the second is timed. Returns (results,
    {tid: last reported loss}, job-steps/s of each run, launches per
    card and in total over both runs)."""
    import torch

    from artstyletransfer_tpu_torch.kernels import (LAUNCHES,
                                                     device_launches,
                                                     reset_launches)
    from artstyletransfer_tpu_torch.parallel import run_job_queue

    rates = []
    reset_launches()  # ---- this run of the path starts here ----
    for _ in range(2):
        losses = {}

        def progress(tid, pct, img, loss, losses=losses):
            losses[tid] = loss

        t0 = time.time()
        results, failures = run_job_queue(jobs, cfg, params=params,
                                          progress=progress, mesh=mesh,
                                          canonicalize_styles=True)
        torch.cuda.synchronize()
        rates.append(len(jobs) * cfg.iters_num / (time.time() - t0))
        if failures:
            raise next(iter(failures.values()))
    return results, losses, rates, device_launches(), dict(LAUNCHES)


def shard_references(jobs, cfg, params, mesh):
    """{tid: (final image, final loss)} of each job run with no mesh in a
    one-card batch of the lanes its shard holds on the mesh: run_job_queue's
    groups (one per bucket here), padded to the jobs axis, each lane's init
    seeded by its index in the group, cut into the shards' lanes."""
    import numpy as np

    from artstyletransfer_tpu_torch.engine.init_pipeline import (
        build_init_image)
    from artstyletransfer_tpu_torch.parallel import BatchedTransferJob
    from artstyletransfer_tpu_torch.parallel.batch import (
        bucket_jobs, canonicalize_style)

    axis = mesh.shape["jobs"]
    out = {}
    canon = [(t, c, canonicalize_style(s, cfg)) for t, c, s in jobs]
    for group in bucket_jobs(canon).values():
        lanes = group + [group[-1]] * (-len(group) % axis)
        inits = [build_init_image(cfg.init_method, c, s, cfg,
                                  rng=np.random.default_rng(cfg.seed + i))[0]
                 for i, (_t, c, s) in enumerate(lanes)]
        per = len(lanes) // axis
        for k, dev in enumerate(mesh.jobs_devices()):
            sl = slice(k * per, (k + 1) * per)
            part = lanes[sl]
            _d, imgs, losses = list(BatchedTransferJob(
                [j[1] for j in part], [j[2] for j in part], cfg,
                params=params, init_overrides=inits[sl],
                device=dev).run())[-1]
            for (tid, _c, _s), img, loss in zip(part, imgs, losses):
                out.setdefault(tid, (img, float(loss)))
    return out


def mesh_queue(mesh, params):
    """The queue phase's 8 Adam jobs at 'highest' through run_job_queue on
    the mesh and on no mesh. Each mesh job within MESH_GATE of itself run
    with no mesh in a one-card batch of its shard's lanes
    (shard_references); against the whole group on one card the loss
    gate (PERF.md §2's queue-lane rtol 1e-3) holds and the PSNR is
    printed: a batch of other lanes sums cuDNN's convolutions in another
    order, and 20 Adam steps carry that into the images (PERF.md §6 PR
    13)."""
    from artstyletransfer_tpu_torch.config import Config

    adam_jobs, _lbfgs = queue_jobs()
    cfg = Config(**MESH_ADAM)
    res_m, loss_m, rates_m, cards, total = timed_queue(adam_jobs, cfg,
                                                       params, mesh)
    res_1, loss_1, rates_1, _c, _t = timed_queue(adam_jobs, cfg, params,
                                                 None)
    refs = shard_references(adam_jobs, cfg, params, mesh)
    jobs = {tid: dict(psnr_db=psnr(res_m[tid], refs[tid][0]),
                      loss_rel=abs(loss_m[tid] / refs[tid][1] - 1.0),
                      vs_one_card_psnr_db=psnr(res_m[tid], res_1[tid]),
                      vs_one_card_loss_rel=abs(loss_m[tid] / loss_1[tid]
                                               - 1.0))
            for tid, _c2, _s in adam_jobs}
    rec = dict(phase="mesh", run="queue_adam_highest", jobs=len(adam_jobs),
               steps=cfg.iters_num, job_steps_per_s_mesh=rates_m,
               job_steps_per_s_no_mesh=rates_1, vs_no_mesh=jobs,
               launches_per_card=per_card(mesh, cards, "queue"))
    emit(rec)
    RECORD.setdefault("mesh", []).append(rec)
    for tid, j in jobs.items():
        if not (j["psnr_db"] > MESH_GATE["psnr_db"]
                and j["loss_rel"] <= MESH_GATE["loss_rtol"]
                and j["vs_one_card_loss_rel"] <= MESH_GATE["loss_rtol"]):
            raise AssertionError(f"mesh job {tid}: {j} outside {MESH_GATE}")
    return total


def mesh_shrink(mesh, params):
    """A unit L-BFGS batch of 2A lanes on a mesh whose jobs axis is A; its
    first A lanes are black (loss and gradient 0), latch and leave at step
    4, and the A lanes left re-form one a shard, so each moves to another
    shard's card (the first A shards'). The real lanes' losses must be
    finite and falling."""
    import numpy as np

    from artstyletransfer_tpu_torch.config import Config
    from artstyletransfer_tpu_torch.engine.pyramid import resize_to_level
    from artstyletransfer_tpu_torch.kernels import (LAUNCHES,
                                                     device_launches,
                                                     reset_launches)
    from artstyletransfer_tpu_torch.parallel import BatchedTransferJob

    axis = mesh.shape["jobs"]
    cfg = Config(**MESH_LBFGS)
    pairs = [synthetic_pair(seed=40 + i) for i in range(axis)]
    black = np.zeros_like(pairs[0][0])
    contents = [black] * axis + [c for c, _s in pairs]
    styles = [black] * axis + [s for _c, s in pairs]
    inits = [resize_to_level(c, cfg.levels_num - 1, cfg.base_diameter)
             for c in contents]
    job = BatchedTransferJob(contents, styles, cfg, params=params,
                             mesh=mesh, init_overrides=inits)
    warmed = job.warm_shrink_graphs()
    err = io.StringIO()
    reset_launches()  # ---- this run of the path starts here ----
    t0 = time.time()
    with contextlib.redirect_stderr(err):
        out = [(done, [float(v) for v in losses])
               for done, _imgs, losses in job.run(yield_images=False)]
    wall = time.time() - t0
    cards, total = device_launches(), dict(LAUNCHES)  # ---- ends here ----
    rec = dict(phase="mesh", run="lbfgs_unit_shrink", lanes=2 * axis,
               shrink=err.getvalue().strip(), losses=out, wall_s=wall,
               shrink_graphs_warmed=warmed,
               launches_per_card=per_card(mesh, cards, "lbfgs shrink"))
    emit(rec)
    RECORD.setdefault("mesh", []).append(rec)
    if f"batch {2 * axis} -> {axis}" not in rec["shrink"]:
        raise AssertionError(f"mesh lbfgs: no {2 * axis} -> {axis} shrink "
                             f"({rec['shrink']})")
    first, last = out[0][1], out[-1][1]
    for lane in range(axis, 2 * axis):
        if not (np.isfinite(last[lane]) and last[lane] < first[lane]):
            raise AssertionError(f"mesh lbfgs lane {lane}: losses {out} are "
                                 "not finite and falling")
    return total


def mesh_online(mesh, params):
    """One OnlineBatchingExecutor session on the mesh: two Adam jobs, and a
    joiner once the first progress arrives."""
    import numpy as np

    from artstyletransfer_tpu_torch.config import Config
    from artstyletransfer_tpu_torch.kernels import (LAUNCHES,
                                                     device_launches,
                                                     reset_launches)

    jobs, _lbfgs = online_jobs()
    cfg = Config(**dict(ONLINE_ADAM, iters_num=20))
    reset_launches()  # ---- this run of the path starts here ----
    ex, wait, losses, finals, wall = online_session(
        cfg, jobs[:2], jobs[2:3], params, mesh=mesh)
    cards, total = device_launches(), dict(LAUNCHES)  # ---- ends here ----
    rec = dict(phase="mesh", run="online_adam", tasks=3,
               seconds_to_first_progress=wait, wall_s=wall,
               job_steps_per_s=3 * cfg.iters_num / wall,
               launches_per_card=per_card(mesh, cards, "online"))
    emit(rec)
    RECORD.setdefault("mesh", []).append(rec)
    for tid, seen in losses.items():
        vals = [loss for _p, loss in seen]
        if tid not in finals or not (np.isfinite(vals).all()
                                     and vals[-1] < vals[0]):
            raise AssertionError(f"mesh online {tid}: {seen}")
    return total


def mesh_memory(mesh):
    """memory_stats of a 4-lane 512 px Adam batch on the mesh: the
    prediction per card beside each card's measured peak."""
    from artstyletransfer_tpu_torch.config import Config
    from artstyletransfer_tpu_torch.parallel.memory import memory_stats

    cfg = Config(**dict(MESH_ADAM, conv_precision="default"))
    stats = memory_stats(cfg, (512, 512), 4, mesh=mesh)
    rec = dict(phase="mesh", run="memory_stats", batch=4,
               lanes_per_card=stats["lanes_per_card"],
               predicted_gb=gb(stats["predicted_bytes"]),
               argument_gb=gb(stats["argument_bytes"]),
               saved_activation_gb=gb(stats["saved_activation_bytes"]),
               per_card=[dict(device=c["device"],
                              peak_gb=gb(c["peak_bytes"]),
                              allocated_before_gb=gb(
                                  c["allocated_before_bytes"]))
                         for c in stats["per_card"]])
    emit(rec)
    RECORD.setdefault("mesh", []).append(rec)
    if any(not c["peak_gb"] > 0 for c in rec["per_card"]):
        raise AssertionError(f"mesh memory: {rec}")


def phase_mesh():
    """Jobs placed over several cards (see the module docstring)."""
    import torch

    from artstyletransfer_tpu_torch.config import Config
    from artstyletransfer_tpu_torch.models.weights import init_vgg19_params
    from artstyletransfer_tpu_torch.parallel.mesh import jobs_mesh

    smi = cards_smi()
    count = torch.cuda.device_count()
    if count >= 2:
        mesh, what = jobs_mesh(), f"{count} cards"
    else:
        mesh = jobs_mesh(devices=["cuda:0", "cuda:0"])
        what = "rehearsal, 1 card"
    emit({"mesh": what})
    emit({"phase": "mesh", "cards": count, "smi": smi,
          "devices": [str(d) for d in mesh.devices]})
    RECORD["mesh_cards"] = dict(cards=count, smi=smi, mesh=what)
    params = init_vgg19_params(seed=0)
    t0 = time.time()
    paths = {"mesh_queue": mesh_queue(mesh, params),
             "mesh_lbfgs_shrink": mesh_shrink(mesh, params),
             "mesh_online": mesh_online(mesh, params)}
    mesh_memory(mesh)
    emit({"phase": "mesh", "wall_s": time.time() - t0})
    cfgs = {"mesh_queue": MESH_ADAM, "mesh_lbfgs_shrink": MESH_LBFGS,
            "mesh_online": ONLINE_ADAM}
    for name, launches in paths.items():
        check_launches(name, launches, card_step(Config(**cfgs[name])))
    return paths


# the space phase: the large job at full float32, eager on both sides
SPACE_ADAM = dict(LARGE, conv_precision="highest", iters_num=5,
                  stream_every=1)
SPACE_LBFGS = dict(LARGE, optimizer="lbfgs", lbfgs_t_init="unit",
                   conv_precision="highest", remat_levels=True,
                   iters_num=2, stream_every=1)
SPACE_GATE = dict(loss_rtol=1e-4, grad_rel=1e-4, adam_rtol=1e-3,
                  grad_rel_of_control=2.0, downscale_rel=1e-5)
# the large job's top level alone: its first evaluation takes the same
# input bits on both sides
SPACE_TOP = dict(SPACE_ADAM, levels_num=1, base_diameter=LARGE_HW)
SEAM_AXES = (2, 4)  # space axes whose 2048 px block shapes the seam rows check
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")


def seam_rows(gen, rows):
    """The TV kernels at a seam (parallel/space.py) at every block shape
    of the 2048 px 4-level job over SEAM_AXES: an integer-valued block of
    h/S rows of an h x h x 3 level, h_total = h and the next block's first
    row as its halo, against the plain versions (float32 and float64,
    tv_rows' tolerances); the block's own rows must give the kernel's bits
    without the halo (the forward's sum over |dx|, every backward row but
    the last), and the halo row's gradient is checked as the grad is.
    Bounds: y and the halo read once, 5 floats a lane written (forward);
    y, the halo, g and the means read, the grad and the halo's gradient
    written (backward)."""
    import torch

    from artstyletransfer_tpu_torch.kernels import tv as ktv

    dev = torch.device("cuda")
    for n in SEAM_AXES:
        for h in (LARGE_HW >> lvl for lvl in range(LARGE["levels_num"])):
            shape = (1, h // n, h)
            y = torch.randint(-128, 128, (1, h // n, h, 3), generator=gen,
                              device=dev).float()
            halo = torch.randint(-128, 128, (1, h * 3), generator=gen,
                                 device=dev).float()
            g = torch.rand((1,), generator=gen, device=dev) + 0.5
            tag = dict(seam=n, image=h, h=h // n, w=h)
            out = one_launch("tv", lambda: ktv._tv_out(y, h, halo))
            alone = ktv._tv_out(y, h)
            _tv, ref = ktv.tv_plain(y, h, halo)
            _tv64, ref64 = ktv.tv_plain(y.double(), h, halo.double())
            torch.cuda.synchronize()
            if not torch.equal(out[:, 3], alone[:, 3]):
                raise AssertionError(f"tv seam {shape}: the block's own "
                                     "|dx| sum differs from the kernel's")
            err, rel, tol = _check("tv", "float32", out[:, 1:3], ref, shape)
            b_ms, b_by = bound(y.numel() * 4 + halo.numel() * 4 + 20,
                               6 * y.numel(), "float32")
            rows.append(dict(
                kernel="tv", dtype="float32", **tag, max_abs_err=err,
                rel_err=rel, tol=tol,
                **f64_check("tv", out[:, 1:3], ref, ref64, shape),
                bound_ms=b_ms, bound_by=b_by,
                **timings(lambda: ktv._tv_out(y, h, halo),
                          lambda: ktv.tv_plain(y, h, halo), None)))
            emit(dict(phase="space", **rows[-1]))

            means = ref.contiguous()
            grad, hgrad = one_launch(
                "tv_bwd", lambda: ktv.tv_bwd_cuda(y, g, means, h, halo))
            alone = ktv.tv_bwd_cuda(y, g, means, h)
            pg, ph = ktv.tv_bwd_plain(y, g, means, h, halo)
            pg64, ph64 = ktv.tv_bwd_plain(y.double(), g.double(),
                                          means.double(), h, halo.double())
            torch.cuda.synchronize()
            if not torch.equal(grad[:, :-1], alone[:, :-1]):
                raise AssertionError(f"tv_bwd seam {shape}: rows above the "
                                     "seam differ from the kernel's")
            both = torch.cat([grad.reshape(-1), hgrad.reshape(-1)])
            ref = torch.cat([pg.reshape(-1), ph.reshape(-1)])
            err, rel, tol = _check("tv_bwd", "float32", both, ref, shape)
            b_ms, b_by = bound(y.numel() * 8 + halo.numel() * 8 + 12,
                               13 * y.numel(), "float32")
            rows.append(dict(
                kernel="tv_bwd", dtype="float32", **tag, max_abs_err=err,
                rel_err=rel, tol=tol,
                **f64_check("tv_bwd", both, ref,
                            torch.cat([pg64.reshape(-1), ph64.reshape(-1)]),
                            shape),
                bound_ms=b_ms, bound_by=b_by,
                **timings(lambda: ktv.tv_bwd_cuda(y, g, means, h, halo),
                          lambda: ktv.tv_bwd_plain(y, g, means, h, halo),
                          None)))
            emit(dict(phase="space", **rows[-1]))


@contextlib.contextmanager
def downscale_halo_grads_dropped():
    """A planted fault: the block downscale's backward without the halo
    rows' gradients, which it adds to the neighbouring blocks' edge rows
    (ops/resize.py DownscaleBlocksFn); its forward is untouched."""
    import torch

    from artstyletransfer_tpu_torch.ops import resize

    real = resize.DownscaleBlocksFn.backward

    def backward(ctx, *gouts):
        grads = list(real(ctx, *gouts))
        n = len(grads)
        for k, (g, (r_h, r_w)) in enumerate(zip(gouts, ctx.mats)):
            e = torch.einsum("iy,bixc->byxc", r_h,
                             torch.einsum("jx,bijc->bixc", r_w, g))
            if k > 0:
                grads[k - 1][:, -1:] -= e[:, :1].to(grads[k - 1].device)
            if k + 1 < n:
                grads[k + 1][:, :1] -= e[:, -1:].to(grads[k + 1].device)
        return tuple(grads)

    with mock.patch.object(resize.DownscaleBlocksFn, "backward",
                           staticmethod(backward)):
        yield


def downscale_rows(gen, count):
    """The block downscale (ops/resize.py downscale2x_blocks) at every
    block shape of the 2048 px 4-level job over SEAM_AXES, its blocks on
    the first S cards where S are visible, else on cuda:0 S times: the
    output and the input gradient of a seeded cotangent, blocks joined,
    against downscale2x of the whole image on cuda:0, each within
    SPACE_GATE["downscale_rel"] of its largest entry (the CPU test's
    bound); with the halo gradients dropped the gradient must fail it."""
    import torch

    from artstyletransfer_tpu_torch.ops.resize import (downscale2x,
                                                       downscale2x_blocks)

    card = torch.device("cuda:0")
    tol = SPACE_GATE["downscale_rel"]
    out = []
    for n in SEAM_AXES:
        devs = [torch.device(f"cuda:{i}" if count >= n else "cuda:0")
                for i in range(n)]
        for h in (LARGE_HW >> lvl for lvl in range(LARGE["levels_num"] - 1)):
            x = torch.randn((1, h, h, 3), generator=gen, device=card) * 50
            cot = torch.randn((1, h // 2, h // 2, 3), generator=gen,
                              device=card)
            xw = x.clone().requires_grad_(True)
            whole = downscale2x(xw)
            (gw,) = torch.autograd.grad(whole, xw, cot)

            def blocks_fwd_bwd():
                xb = [b.to(d).requires_grad_(True) for b, d in
                      zip(torch.chunk(x, n, dim=1), devs)]
                ob = downscale2x_blocks(xb)
                gb = torch.autograd.grad(ob, xb, [
                    c.to(d) for c, d in zip(torch.chunk(cot, n, dim=1),
                                            devs)])
                return (torch.cat([o.detach().to(card) for o in ob], 1),
                        torch.cat([g.to(card) for g in gb], 1))

            ob, gb = blocks_fwd_bwd()
            with downscale_halo_grads_dropped():
                _ob, gbad = blocks_fwd_bwd()

            def rel(a, b):
                return float((a - b).abs().max() / b.abs().max())

            rec = dict(phase="space", op="downscale_blocks", seam=n,
                       image=h, devices=[str(d) for d in devs],
                       fwd_rel=rel(ob, whole.detach()),
                       bwd_rel=rel(gb, gw), tol=tol,
                       bwd_rel_halo_grads_dropped=rel(gbad, gw))
            emit(rec)
            out.append(rec)
            if not (rec["fwd_rel"] <= tol and rec["bwd_rel"] <= tol
                    and rec["bwd_rel_halo_grads_dropped"] > tol):
                raise AssertionError(f"space downscale blocks: {rec}")
    RECORD["space_downscale"] = out


def space_meshes():
    """[(what, mesh)]: the first two cards as one space row, and the first
    four where four are visible; on one card the rehearsal, cuda:0 named
    twice."""
    import torch

    from artstyletransfer_tpu_torch.parallel.mesh import Mesh, jobs_space_mesh

    count = torch.cuda.device_count()
    if count < 2:
        return [("rehearsal, 1 card", Mesh(["cuda:0", "cuda:0"],
                                           ("jobs", "space"), (1, 2)))]
    out = [("2 cards", jobs_space_mesh(1, 2))]
    if count >= 4:
        out.append(("4 cards", jobs_space_mesh(1, 4)))
    return out


def row_cards(mesh):
    return list(dict.fromkeys(mesh.devices))


def reset_peaks(cards):
    import torch

    for d in cards:
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)


def card_peaks(cards):
    """{card: peak allocated GB since reset_peaks}."""
    import torch

    for d in cards:
        torch.cuda.synchronize(d)
    return {str(d): gb(torch.cuda.max_memory_allocated(d)) for d in cards}


def space_run(job, cards):
    """job.run() without images, one step a chunk: (the losses of each
    step, ms of each step on the host's clock with every card of `cards`
    synchronised, the final images, launches in total and per card), the
    counters zeroed just before and read just after."""
    import numpy as np
    import torch

    from artstyletransfer_tpu_torch.kernels import (LAUNCHES,
                                                     device_launches,
                                                     reset_launches)

    for d in cards:
        torch.cuda.synchronize(d)
    losses, ms = [], []
    reset_launches()  # ---- this run of the path starts here ----
    t0 = time.perf_counter()
    for _done, imgs, f in job.run(yield_images=False):
        for d in cards:
            torch.cuda.synchronize(d)
        t1 = time.perf_counter()
        ms.append((t1 - t0) * 1e3)
        t0 = t1
        losses.append(np.asarray(f.cpu() if torch.is_tensor(f) else f,
                                 np.float64)[0])
    launches, cards_l = dict(LAUNCHES), device_launches()  # ---- ends ----
    return losses, ms, imgs[0], launches, cards_l


def space_launches(mesh, cards_l, path):
    """The Gram and TV kernels both ways on every card of the row."""
    out = {}
    for d in row_cards(mesh):
        c = cards_l.get(d.index, {})
        out[str(d)] = {k: c.get(k, 0) for k in ON_EVERY_CARD + ("conv_relu",)}
        missing = [k for k in ON_EVERY_CARD if not c.get(k)]
        if missing:
            raise AssertionError(f"space {path}: {d} launched none of "
                                 f"{missing} ({c})")
    return out


def host_syncs(fn):
    """Host runtime calls of fn() that wait for the device (SYNC_CALLS),
    and its CUDA copies (torch.profiler, CPU and CUDA activity)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
    syncs, copies = {}, 0
    for evt in prof.key_averages():
        if evt.key.startswith(SYNC_CALLS) and not evt.key.startswith(
                "cudaMemcpyAsync"):
            syncs[evt.key] = syncs.get(evt.key, 0) + evt.count
        if (evt.device_type == torch.autograd.DeviceType.CUDA
                and evt.key.startswith("Memcpy")):
            copies += evt.count
    return syncs, copies


def ulp_control(job, x0, g0):
    """The gradient's sensitivity to last bits: the relative L2 distance
    of job's gradient at x0 moved by about one ulp per pixel (-1, 0 or +1
    times 2^-23 |x|, seeded) from g0, its gradient at x0."""
    import numpy as np
    import torch

    r = torch.from_numpy(np.random.default_rng(0).integers(
        -1, 2, tuple(x0.shape)).astype(np.float32)).to(x0.device)
    _f, g = job._loss_grad(x0 + r * x0.abs() * 2.0 ** -23)
    g, g0 = g.cpu().double(), g0.double()
    return float((g - g0).norm() / g0.norm())


def space_references(params):
    """The unsharded job on cuda:0: the first evaluation of the Adam
    lane (and its gradient at an input one ulp away, ulp_control), the
    first evaluation of its top level alone, its 5 eager steps and 5
    graphed ones, and the unit L-BFGS lane's first evaluation and 2 eager
    steps, each with its peak."""
    import torch

    from artstyletransfer_tpu_torch.config import (Config, precision_gate,
                                                    production_config)
    from artstyletransfer_tpu_torch.parallel import BatchedTransferJob

    card = torch.device("cuda:0")
    out = {}
    adam = Config(**SPACE_ADAM)
    contents, style, inits, _ = large_inputs(1, adam)
    for graphed in (False, True):
        free_card()
        job = BatchedTransferJob(contents, [style], adam, params=params,
                                 device=card, init_overrides=inits,
                                 graphs=graphed)
        if not graphed:
            with precision_gate(adam.conv_precision):
                f, g = job._loss_grad(job._x0)
                out["first"] = (f.cpu(), g.cpu())
                out["control"] = ulp_control(job, job._x0, out["first"][1])
        reset_peaks([card])
        losses, ms, img, _l, _c = space_run(job, [card])
        out["graphed" if graphed else "eager"] = dict(
            losses=losses, ms=ms, img=img, peak_gb=card_peaks([card]))
        del job
    free_card()
    top = Config(**SPACE_TOP)
    job = BatchedTransferJob(contents, [style], top, params=params,
                             device=card, init_overrides=inits, graphs=False)
    with precision_gate(top.conv_precision):
        f, g = job._loss_grad(job._x0)
        out["top"] = (f.cpu(), g.cpu())
    del job
    lbfgs = production_config(Config(**SPACE_LBFGS), "cuda")
    free_card()
    job = BatchedTransferJob(contents, [style], lbfgs, params=params,
                             device=card, init_overrides=inits, graphs=False)
    first = float(job.initial_losses()[0])
    reset_peaks([card])
    losses, ms, img, _l, _c = space_run(job, [card])
    out["lbfgs"] = dict(first=first, losses=losses, ms=ms, img=img,
                        peak_gb=card_peaks([card]))
    del job
    free_card()
    return out


@contextlib.contextmanager
def lbfgs_optimizers():
    """The L-BFGS optimizers built while active (their state's history
    blocks are read after a run)."""
    from artstyletransfer_tpu_torch.engine import transfer

    made = []
    real = transfer._Lbfgs.__init__

    def init(self, *a, **kw):
        real(self, *a, **kw)
        made.append(self)

    with mock.patch.object(transfer._Lbfgs, "__init__", init):
        yield made


def first_eval(job, ref):
    """(loss rtol, gradient relative L2, whether a rerun gave the same
    bits) of job's first evaluation against ref, the unsharded one's."""
    import torch

    from artstyletransfer_tpu_torch.config import precision_gate

    with precision_gate(job.cfg.conv_precision):
        f1, g1 = job._loss_grad(job._x0)
        f2, g2 = job._loss_grad(job._x0)
    g1, g2 = g1.cpu(), g2.cpu()
    f0, g0 = ref
    return (float((f1.cpu().double() / f0.double() - 1).abs().max()),
            float((g1.double() - g0.double()).norm() / g0.double().norm()),
            bool(torch.equal(f1, f2) and torch.equal(g1, g2)))


def space_lanes(what, mesh, params, refs):
    """The 2048 px Adam lane and the unit L-BFGS lane on a space row
    against the unsharded references; returns the paths' launches.

    The first evaluation's gradient is held to rtol 1e-4 where both sides
    take the same input bits: the top level alone (SPACE_TOP). Over the
    four levels the block downscale's products sum in another order than
    the whole image's, and the lower levels' inputs differ in their last
    bits; the gradient through VGG19's ReLUs and max-pools moves further
    with them than 1e-4, as much as the unsharded job's own gradient
    moves at an input one ulp away (ulp_control). That gradient is held
    to twice its control, the loss to rtol 1e-4; the block downscale,
    where the orders differ, is held on its own to 1e-5 (downscale_rows),
    and with its halo gradients dropped the 4-level gradient must fail
    the gate (a planted fault, the loss left bit-equal). The Adam losses
    move each step the way the unsharded run's do (its fifth step rises:
    lr overshoot), within rtol 1e-3."""
    import numpy as np
    import torch

    from artstyletransfer_tpu_torch.config import (Config, precision_gate,
                                                    production_config)
    from artstyletransfer_tpu_torch.engine.transfer import lbfgs_history_gb
    from artstyletransfer_tpu_torch.parallel import BatchedTransferJob
    from artstyletransfer_tpu_torch.parallel.memory import memory_stats

    cards = row_cards(mesh)
    n = mesh.shape["space"]
    paths = {}
    adam = Config(**SPACE_ADAM)
    contents, style, inits, _ = large_inputs(1, adam)
    free_card()
    t0 = time.perf_counter()
    job = BatchedTransferJob(contents, [style], adam, params=params,
                             mesh=mesh, shard_space=True,
                             init_overrides=inits)
    construct_s = time.perf_counter() - t0
    if job.space is None:
        raise AssertionError(f"space {what}: the 2048 px job did not shard")
    loss_rel, grad_rel, rerun_bits = first_eval(job, refs["first"])
    with downscale_halo_grads_dropped():
        fault_loss, fault_grad, _bits = first_eval(job, refs["first"])
    with precision_gate(adam.conv_precision):
        syncs, copies = host_syncs(lambda: job._loss_grad(job._x0))
    top = BatchedTransferJob(contents, [style], Config(**SPACE_TOP),
                             params=params, mesh=mesh, shard_space=True,
                             init_overrides=inits)
    top_loss, top_grad, top_bits = first_eval(top, refs["top"])
    del top
    reset_peaks(cards)
    losses, ms, img, launches, per = space_run(job, cards)
    peaks = card_peaks(cards)
    paths["space_adam"] = launches
    one = refs["eager"]
    rel = [abs(a / b - 1) for a, b in zip(losses, one["losses"])]
    rec = dict(phase="space", run="adam_2048", mesh=what,
               devices=[str(d) for d in job.space],
               construct_s=construct_s,
               first_eval=dict(loss_rel=loss_rel, grad_rel_l2=grad_rel,
                               grad_rel_l2_one_ulp_control=refs["control"],
                               rerun_bit_equal=rerun_bits,
                               downscale_halo_grads_dropped=dict(
                                   loss_rel=fault_loss,
                                   grad_rel_l2=fault_grad)),
               first_eval_top_level=dict(loss_rel=top_loss,
                                         grad_rel_l2=top_grad,
                                         rerun_bit_equal=top_bits),
               host_syncs_per_eval=syncs, device_copies_per_eval=copies,
               losses=losses, unsharded_losses=one["losses"], loss_rel=rel,
               psnr_db_vs_unsharded=psnr(img, one["img"]),
               ms_per_step_space_eager=ms,
               ms_per_step_unsharded_eager=one["ms"],
               ms_per_step_unsharded_graphed=refs["graphed"]["ms"],
               peak_gb_per_card=peaks,
               unsharded_peak_gb=one["peak_gb"],
               launches_per_card=space_launches(mesh, per, "adam"))
    emit(rec)
    RECORD.setdefault("space", []).append(rec)
    if not (loss_rel <= SPACE_GATE["loss_rtol"] and rerun_bits
            and grad_rel <= SPACE_GATE["grad_rel_of_control"]
            * refs["control"]
            and fault_grad > SPACE_GATE["grad_rel_of_control"]
            * refs["control"]
            and top_loss <= SPACE_GATE["loss_rtol"] and top_bits
            and top_grad <= SPACE_GATE["grad_rel"]
            and np.isfinite(losses).all() and losses[-1] < losses[0]
            and np.array_equal(np.sign(np.diff(losses)),
                               np.sign(np.diff(one["losses"])))
            and max(rel) <= SPACE_GATE["adam_rtol"]):
        raise AssertionError(f"space adam {what}: {rec}")
    del job
    stats = memory_stats(adam, (LARGE_HW, LARGE_HW), 1, mesh=mesh,
                         shard_space=True)
    emit(dict(phase="space", run="memory_stats_adam", mesh=what,
              **space_stats(stats), measured_peak_gb_per_card=peaks))

    lbfgs = production_config(Config(**SPACE_LBFGS), "cuda")
    free_card()
    job = BatchedTransferJob(contents, [style], lbfgs, params=params,
                             mesh=mesh, shard_space=True,
                             init_overrides=inits)
    first = float(job.initial_losses()[0])
    reset_peaks(cards)
    with lbfgs_optimizers() as made:
        losses, ms, img, launches, per = space_run(job, cards)
    peaks = card_peaks(cards)
    paths["space_lbfgs"] = launches
    hist = made[-1].state.s_hist.blocks, made[-1].state.y_hist.blocks
    one = refs["lbfgs"]
    rec = dict(phase="space", run="lbfgs_unit_2048", mesh=what,
               lbfgs_grams=lbfgs.lbfgs_grams,
               first_eval_loss_rel=abs(first / one["first"] - 1),
               losses=losses, unsharded_losses=one["losses"],
               psnr_db_vs_unsharded=psnr(img, one["img"]),
               ms_per_step_space_eager=ms,
               ms_per_step_unsharded_eager=one["ms"],
               history_gb_per_shard=[gb(s.numel() * s.element_size()
                                        + y.numel() * y.element_size())
                                     for s, y in zip(*hist)],
               history_gb_formula=lbfgs_history_gb(
                   lbfgs, job.level_shapes, 1, n),
               peak_gb_per_card=peaks, unsharded_peak_gb=one["peak_gb"],
               launches_per_card=space_launches(mesh, per, "lbfgs"))
    emit(rec)
    RECORD.setdefault("space", []).append(rec)
    del job, made, hist
    if not (rec["first_eval_loss_rel"] <= SPACE_GATE["loss_rtol"]
            and np.isfinite(losses).all() and losses[-1] < first):
        raise AssertionError(f"space lbfgs {what}: {rec}")
    free_card()
    stats = memory_stats(lbfgs, (LARGE_HW, LARGE_HW), 1, mesh=mesh,
                         shard_space=True)
    emit(dict(phase="space", run="memory_stats_lbfgs", mesh=what,
              **space_stats(stats), measured_peak_gb_per_card=peaks))
    free_card()
    return paths


def space_stats(stats):
    """memory_stats' space report in GB."""
    return dict(
        predicted_gb=gb(stats["predicted_bytes"]),
        per_shard=[dict(device=s["device"],
                        **{k.replace("_bytes", "_gb"): gb(v)
                           for k, v in s.items() if k.endswith("_bytes")})
                   for s in stats["per_shard"]],
        per_card=[dict(device=c["device"], peak_gb=gb(c["peak_bytes"]),
                       allocated_before_gb=gb(c["allocated_before_bytes"]))
                  for c in stats.get("per_card", [])])


def phase_space():
    """One job's pixels over the cards of a space row (see the module
    docstring). Returns (the paths' launches, the seam kernel rows)."""
    import torch

    from artstyletransfer_tpu_torch.config import precision_gate
    from artstyletransfer_tpu_torch.models.weights import init_vgg19_params

    t0 = time.time()
    smi = cards_smi()
    count = torch.cuda.device_count()
    meshes = space_meshes()
    emit({"space": [what for what, _m in meshes]})
    emit({"phase": "space", "cards": count, "smi": smi,
          "peer_access": {f"{a}->{b}": torch.cuda.can_device_access_peer(a, b)
                          for a in range(min(count, 4))
                          for b in range(min(count, 4)) if a != b}})
    rows = []
    seam_rows(torch.Generator(device="cuda").manual_seed(14), rows)
    with precision_gate("highest"):
        downscale_rows(torch.Generator(device="cuda").manual_seed(15), count)
    params = init_vgg19_params(seed=0)
    refs = space_references(params)
    paths = {}
    for what, mesh in meshes:
        for name, launches in space_lanes(what, mesh, params, refs).items():
            paths[f"{name}_{mesh.shape['space']}"] = launches
    emit({"phase": "space", "wall_s": time.time() - t0})
    for name, launches in paths.items():
        # a space row's lanes (SpaceLanes) keep the host path
        check_launches(name, launches, False)
    return paths, rows


def lbfgs_coef_rows(gen_seed: int = 11):
    """The two-loop coefficient kernel (kernels/lbfgs.py) at history 100:
    one launch for five lanes holding 0, 1, 37, 100 and 237 (wrapped)
    pairs, and one for 8 lanes of 237, against engine/lbfgs.py's numpy
    recursion (within 2e-6 of the largest coefficient); device ms, the
    plain version's (the same recursion as torch ops on the card, device
    time only), the bound (the Grams and vectors read once, the
    coefficients written once)."""
    import numpy as np
    import torch

    from artstyletransfer_tpu_torch.engine.lbfgs import _two_loop_coefficients
    from artstyletransfer_tpu_torch.kernels import lbfgs as klbfgs

    rng = np.random.default_rng(gen_seed)
    m, n = 100, 4096
    rows = []
    for counts, tag in (([0, 1, 37, 100, 237], {}),
                        ([237] * LANES, {"lanes": LANES})):
        lanes = len(counts)
        P = np.zeros((lanes, m, m), np.float32)
        Q = np.zeros_like(P)
        u, v, rho = (np.zeros((lanes, m), np.float32) for _ in range(3))
        for b, count in enumerate(counts):
            S = np.zeros((m, n), np.float32)
            Y = np.zeros((m, n), np.float32)
            for k in range(count):
                s_ = rng.standard_normal(n).astype(np.float32)
                y_ = (s_ * rng.uniform(0.5, 2.0, n)
                      + 0.1 * rng.standard_normal(n)).astype(np.float32)
                S[k % m], Y[k % m] = s_, y_
                rho[b, k % m] = 1.0 / np.dot(y_, s_)
            g = rng.standard_normal(n).astype(np.float32)
            P[b], Q[b], u[b], v[b] = S @ Y.T, Y @ Y.T, S @ g, Y @ g
        dev = [torch.from_numpy(a).cuda() for a in (P, Q, u, v, rho)]
        count = torch.tensor(counts, dtype=torch.int64, device="cuda")
        gamma, cs, cy = one_launch(
            "lbfgs_coef", lambda: klbfgs.two_loop_coefficients_cuda(
                *dev, count))
        again = klbfgs.two_loop_coefficients_cuda(*dev, count)
        same_bits("lbfgs_coef", torch.cat([gamma, cs.ravel(), cy.ravel()]),
                  torch.cat([again[0], again[1].ravel(), again[2].ravel()]))
        err = 0.0
        for b, cnt in enumerate(counts):
            g_h, cs_h, cy_h = _two_loop_coefficients(P[b], Q[b], u[b], v[b],
                                                     rho[b], cnt)
            scale = max(np.abs(cs_h).max(), np.abs(cy_h).max(), 1e-30)
            err = max(err, float(np.abs(cs[b].cpu().numpy() - cs_h).max()
                                 / scale),
                      float(np.abs(cy[b].cpu().numpy() - cy_h).max() / scale),
                      abs(float(gamma[b]) - float(g_h)) / abs(float(g_h)))
        if not err <= 2e-6:
            raise AssertionError(f"lbfgs_coef {counts}: error {err:.3e} of "
                                 "the largest coefficient > 2e-6")
        bound_ms, by = bound(lanes * (2 * m * m + 5 * m + 3) * 4,
                             lanes * 6 * m * m, "float32")
        rec = dict(phase="lbfgs_card", kernel="lbfgs_coef", dtype="float32",
                   m=m, counts=counts, **tag, max_abs_err=err, rel_err=err,
                   tol=2e-6, bound_ms=bound_ms, bound_by=by,
                   **timings(lambda: klbfgs.two_loop_coefficients_cuda(
                       *dev, count),
                       lambda: klbfgs.two_loop_coefficients_plain(
                           *dev, count), None))
        emit(rec)
        rows.append(rec)
    return rows


def lbfgs_card_jobs(params):
    """The bot's job (production_config on CUDA: 2 levels, 512 px, lr
    opening, history 100, carried Grams) for 60 steps through
    BatchedTransferJob, its steps on the card (CardSteps) and on the host
    (engages off), in turns card, host, host, card: ms a step past the
    first chunk; over a profiled 30-step run of each, host launches, blocking
    reads (lbfgs.read spans), evaluations (TV forward launches / levels)
    and device-busy ms a step, and the lbfgs.step paths; the final losses
    and images of the two against each other (reported: L-BFGS at lr 10
    branches on float32 comparisons, so the two part after a while)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from artstyletransfer_tpu_torch.config import Config, production_config
    from artstyletransfer_tpu_torch.engine import lbfgs_card
    from artstyletransfer_tpu_torch.kernels import LAUNCHES
    from artstyletransfer_tpu_torch.parallel import BatchedTransferJob
    from artstyletransfer_tpu_torch.utils.metrics import recorded_spans

    content, style = synthetic_pair()
    cfg = production_config(Config(levels_num=2, base_diameter=256,
                                   iters_num=60, stream_every=10,
                                   optimizer="lbfgs"), "cuda")
    engages = lbfgs_card.engages
    rates, finals, profiles = {}, {}, {}
    try:
        for way in ("card", "host", "host", "card"):
            lbfgs_card.engages = (engages if way == "card"
                                  else lambda *a: False)
            job = BatchedTransferJob([content], [style], cfg, params=params,
                                     device="cuda")
            stamps = []
            for done, imgs, losses in job.run():
                stamps.append((time.perf_counter(), done, imgs, losses))
            (t_a, d_a, _i, _l), (t_b, d_b, img, loss) = stamps[0], stamps[-1]
            rates.setdefault(way, []).append((t_b - t_a) * 1e3 / (d_b - d_a))
            finals.setdefault(way, (img[0], float(loss[0])))
            if way in profiles:
                continue
            job = BatchedTransferJob([content], [style], cfg, params=params,
                                     device="cuda")
            tv0 = LAUNCHES["tv"]
            t0 = time.time_ns()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _out in job.run(iters_num=30):
                    pass
                torch.cuda.synchronize()
            spans = recorded_spans(t0)
            launches, _kernels = host_launches(prof)
            busy_us = sum(
                float(getattr(e, "self_device_time_total",
                              getattr(e, "self_cuda_time_total", 0)))
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA)
            profiles[way] = dict(
                host_launches_per_step=launches / 30,
                reads_per_step=sum(s.name == "lbfgs.read"
                                   for s in spans) / 30,
                evals_per_step=(LAUNCHES["tv"] - tv0) / 2 / 30,
                device_ms_per_step=busy_us / 1e3 / 30,
                paths=sorted({s.attrs["path"] for s in spans
                              if s.name == "lbfgs.step"}))
            if profiles[way]["paths"] != [way]:
                raise AssertionError(f"lbfgs_card {way}: {profiles[way]}")
    finally:
        lbfgs_card.engages = engages
    (ic, lc), (ih, lh) = finals["card"], finals["host"]
    for way, (img, loss) in finals.items():
        if not (np.isfinite(img).all() and np.isfinite(loss)):
            raise AssertionError(f"lbfgs_card {way}: non-finite result")
    rec = dict(phase="lbfgs_card", run="job", steps=cfg.iters_num,
               ms_per_step=rates, **{f"{k}_profile": v
                                     for k, v in profiles.items()},
               final_loss=dict(card=lc, host=lh),
               final_loss_rel=abs(lc / lh - 1.0), final_psnr_db=psnr(ic, ih))
    emit(rec)
    return rec


def phase_lbfgs_card():
    """The L-BFGS step on the card: the coefficient kernel's rows, then
    the bot's job on the card and on the host."""
    from artstyletransfer_tpu_torch.kernels import reset_launches
    from artstyletransfer_tpu_torch.models.weights import init_vgg19_params

    rows = lbfgs_coef_rows()
    reset_launches()
    job = lbfgs_card_jobs(init_vgg19_params(seed=0))
    RECORD["lbfgs_card"] = dict(rows=rows, job=job)
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import artstyletransfer_tpu_torch  # noqa: F401  (fails outside a checkout)

    smi = phase_build()
    rows = phase_kernels()
    phase_golden()
    phase_glue()
    paths = {"main": phase_main()}
    paths.update(phase_queue())
    paths.update(phase_lbfgs_state())
    paths.update(phase_resume())
    paths.update(phase_graphs())
    paths.update(phase_online())
    paths.update(phase_frontends())
    paths.update(phase_large())
    paths.update(phase_lookahead())
    paths.update(phase_builders())
    paths.update(phase_mesh())
    space_paths, seam = phase_space()
    paths.update(space_paths)
    coef = phase_lbfgs_card()
    summary = kernel_summary(rows + seam + coef, paths)
    RECORD["summary"] = summary
    RECORD["gpu"] = smi
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as fh:
        json.dump(RECORD, fh, indent=1)
    print(smi)
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
