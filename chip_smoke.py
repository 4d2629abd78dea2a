#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout, with no setup: it builds the port's CUDA
kernels from artstyletransfer_tpu_torch/kernels/csrc with nvcc, then

1. build    — compiles every kernel source (in parallel) and reports the
              card's name and power limit (nvidia-smi);
2. kernels  — calls each kernel on the card at every shape the main path
              gives it (Gram forward/backward in float32 and bfloat16, TV
              at 512², 256² and 511x769), holds it against its plain
              PyTorch version with a stated tolerance, and times it (device
              time from torch.profiler) beside its bound, the plain version
              and one library call;
3. golden   — reruns two of the JAX package's committed one-step goldens
              (tests/goldens) on the card at full float32 precision;
4. main     — drives the main path, Executor -> neural_style_transfer ->
              TransferJob, at full VGG19 width on seeded synthetic 512x512
              images: 10 L-BFGS steps (history 100, 25 line-search evals)
              then 20 Adam steps, 2 pyramid levels (256 and 512). The
              kernels' launch counters are zeroed just before and read just
              after; every kernel must have launched and the loss must be
              finite and lower than at the start.

Each phase prints one JSON line. Any failure raises and exits non-zero;
without a CUDA device it exits 1 before printing any result. The last
lines are the card's nvidia-smi line, the `kernels` summary and
{"ok": true, "device": {...}}. All images are numpy arrays made from
seeds (no image files, no OpenCV). A full record of every measurement is
also written to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import asyncio
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet), for the bounds
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}

SRC = "artstyletransfer_tpu_torch/kernels/csrc/"
PALLAS = "artstyletransfer_tpu/ops/pallas_kernels.py"
KERNELS = {
    "gram": dict(source=SRC + "gram.cu", replaces=PALLAS + ":52"),
    "gram_bwd": dict(source=SRC + "gram_bwd.cu", replaces=PALLAS + ":107"),
    "tv": dict(source=SRC + "tv.cu", replaces=PALLAS + ":171"),
}
# (n = h*w, c) of the five style taps at 512 px (level 1) and 256 px
# (level 0): the Gram shapes of one loss evaluation
GRAM_SHAPES = [(512 * 512, 64), (256 * 256, 128), (128 * 128, 256),
               (64 * 64, 512), (32 * 32, 512),
               (256 * 256, 64), (128 * 128, 128), (64 * 64, 256),
               (32 * 32, 512), (16 * 16, 512)]
TV_SHAPES = [(512, 512), (256, 256)]     # one loss evaluation
TV_EXTRA = [(511, 769)]                  # an odd shape
TOL = {  # max |kernel - plain| / max |plain|
    ("gram", "float32"): 1e-4, ("gram", "bfloat16"): 1e-4,
    ("gram_bwd", "float32"): 1e-4,
    ("gram_bwd", "bfloat16"): 1e-2,  # output rounded to bf16 (2^-8)
    ("tv", "float32"): 1e-4,
}

RECORD = {}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


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


def _profiled_device_ms(fn, reps: int) -> float:
    """Mean device time per call of fn: the summed duration of every CUDA
    kernel it launched (torch.profiler / CUPTI), gaps excluded; 0 when the
    profiler recorded no kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            total_us += float(getattr(evt, "self_device_time_total",
                                      getattr(evt, "self_cuda_time_total", 0)))
    return total_us / 1e3 / reps


def device_ms(fn, reps: int = 20, attempts: int = 5) -> float:
    """The profiler's device time per call of fn. A profiler session that
    records no kernel at all is retried; after `attempts` empty sessions
    this raises, so that every `ms`, `plain_ms` and `library_ms` is
    measured the same way."""
    import torch

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        ms = _profiled_device_ms(fn, reps)
        if ms > 0:
            return ms
    raise RuntimeError(f"torch.profiler recorded no CUDA kernel in "
                       f"{attempts} sessions")


def timings(kernel_fn, plain_fn, library_fn):
    """Device ms of the kernel, its plain version and the library call
    (device_ms, kernels only), plus the kernel's per-call ms on the
    device's clock (cuda_ms, host gaps included), kept apart as
    `call_ms`."""
    return dict(ms=device_ms(kernel_fn), plain_ms=device_ms(plain_fn),
                library_ms=None if library_fn is None else device_ms(library_fn),
                call_ms=cuda_ms(kernel_fn))


def bound(bytes_moved: float, ops: float, dtype: str):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
           "gpu": smi}
    emit(rec)
    RECORD["build"] = dict(rec, ptxas=ptxas)
    return smi


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
    from artstyletransfer_tpu_torch.kernels import tv as ktv

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
            torch.cuda.synchronize()
            err, rel, tol = _check("gram", dtype, out, ref, (n, c))
            elem = f.element_size()
            # G is symmetric: the function needs its upper triangle only,
            # c*(c+1)/2 dot products of length n (as gram.cu computes it)
            b_ms, b_by = bound(n * c * elem + c * c * 4, n * c * (c + 1),
                               dtype)
            rows.append(dict(
                kernel="gram", dtype=dtype, n=n, c=c, max_abs_err=err,
                rel_err=rel, tol=tol, bound_ms=b_ms, bound_by=b_by,
                **timings(lambda: kgram.gram_cuda(f, s),
                          lambda: kgram.gram_plain(f, s),
                          lambda: torch.matmul(f.T, f))))
            emit(dict(phase="kernels", **rows[-1]))

            g = torch.randn((c, c), generator=gen, device=dev) * s
            g = (g + g.T).contiguous()
            out = kgram.gram_bwd_cuda(f, g)
            ref = kgram.gram_bwd_plain(f, g)
            torch.cuda.synchronize()
            err, rel, tol = _check("gram_bwd", dtype, out, ref, (n, c))
            g_lib = g.to(tdt)
            b_ms, b_by = bound(2 * n * c * elem + c * c * 4, 2 * n * c * c,
                               dtype)
            rows.append(dict(
                kernel="gram_bwd", dtype=dtype, n=n, c=c, max_abs_err=err,
                rel_err=rel, tol=tol, bound_ms=b_ms, bound_by=b_by,
                **timings(lambda: kgram.gram_bwd_cuda(f, g),
                          lambda: kgram.gram_bwd_plain(f, g),
                          lambda: torch.matmul(f, g_lib))))
            emit(dict(phase="kernels", **rows[-1]))
    for h, w in TV_SHAPES + TV_EXTRA:
        y = torch.randn((1, h, w, 3), generator=gen, device=dev) * 100.0
        out = torch.stack(ktv.tv_sums_cuda(y))
        ref = torch.stack(ktv.tv_sums_plain(y))
        torch.cuda.synchronize()
        err, rel, tol = _check("tv", "float32", out, ref, (h, w))
        b_ms, b_by = bound(y.numel() * 4 + 8, 6 * y.numel(), "float32")
        rows.append(dict(
            kernel="tv", dtype="float32", h=h, w=w, max_abs_err=err,
            rel_err=rel, tol=tol, bound_ms=b_ms, bound_by=b_by,
            **timings(lambda: ktv.tv_sums_cuda(y),
                      lambda: ktv.tv_sums_plain(y), None)))
        emit(dict(phase="kernels", **rows[-1]))
    RECORD["kernels"] = rows
    return rows


def kernel_summary(rows, launches):
    """One entry per kernel: the main path's float32 shapes of one loss
    evaluation, times summed over them (kernel, plain, library, bound)."""
    main_tv = {(h, w) for h, w in TV_SHAPES}
    out = []
    for name, meta in KERNELS.items():
        sel = [r for r in rows if r["kernel"] == name
               and r["dtype"] == "float32"
               and (name != "tv" or (r["h"], r["w"]) in main_tv)]
        t_bytes = sum(r["bound_ms"] for r in sel if r["bound_by"] == "bytes")
        t_ops = sum(r["bound_ms"] for r in sel if r["bound_by"] == "operations")
        lib = [r["library_ms"] for r in sel]
        out.append(dict(
            name=name, route="cuda", source=meta["source"],
            replaces=meta["replaces"], launches=launches[name],
            max_abs_err=max(r["max_abs_err"] for r in sel),
            ms=sum(r["ms"] for r in sel),
            call_ms=sum(r["call_ms"] for r in sel),
            plain_ms=sum(r["plain_ms"] for r in sel),
            bound_ms=sum(r["bound_ms"] for r in sel),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=None if None in lib else sum(lib)))
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
    if not all(v > 0 for v in launches.values()):
        raise AssertionError(f"a kernel never launched on the main path: "
                             f"{launches}")
    return launches


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
    launches = phase_main()
    summary = kernel_summary(rows, launches)
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
