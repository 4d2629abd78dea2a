"""Command-line frontend: one headless style-transfer run on the card.

The port of the JAX package's ``astt`` CLI (frontends/cli.py), with the
flags this package's engine implements plus --device (default cuda; the
run raises if no card is visible and --device cpu was not given).
--checkpoint FILE [--checkpoint-every N] [--resume] saves and resumes the
job's whole optimization state.

  python -m artstyletransfer_tpu_torch.frontends.cli \\
      --content bird.jpg --style cubism2.jpg --output out.jpg
  python -m artstyletransfer_tpu_torch.frontends.cli --preset smoke \\
      --device cpu --content a.jpg --style b.jpg --output out.jpg

Reading and writing JPEGs needs OpenCV (utils/image.py).
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import sys
import time
import uuid

import numpy as np

from ..config import PRESETS, Config, production_config, resolve_device
from ..engine.transfer import ContentStylePair
from ..runtime.executor import Executor
from ..utils.image import load_image, save_image


def add_engine_flags(p: argparse.ArgumentParser) -> None:
    """Engine/Config flags; config_from_args consumes the namespace."""
    p.add_argument("--preset", choices=sorted(PRESETS), default=None,
                   help="named config preset (overridden by explicit flags)")
    d = Config()
    p.add_argument("--optimizer", choices=["lbfgs", "adam"], default=None)
    p.add_argument("--init-method",
                   choices=["random", "content+noise", "style"], default=None)
    p.add_argument("--use-relu", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="post-ReLU feature taps (reference default); "
                        "--no-use-relu selects the pre-ReLU conv taps")
    p.add_argument("--levels", type=int, default=None,
                   help=f"pyramid levels (default {d.levels_num})")
    p.add_argument("--iters", type=int, default=None,
                   help=f"optimizer steps (default {d.iters_num})")
    p.add_argument("--content-weight", type=float, default=None)
    p.add_argument("--style-weight", type=float, default=None)
    p.add_argument("--tv-weight", type=float, default=None)
    p.add_argument("--noise-factor", type=float, default=None)
    p.add_argument("--base-diameter", type=int, default=None,
                   help="shortest side at pyramid level 0 (default 256)")
    p.add_argument("--stream-every", type=int, default=None,
                   help="steps per progress update (default 10)")
    p.add_argument("--compute-dtype", choices=["float32", "bfloat16"],
                   default=None, help="conv compute dtype (default float32)")
    p.add_argument("--conv-precision", choices=["default", "high", "highest"],
                   default=None,
                   help="default/high allow TF32 in cuDNN convs and matmuls; "
                        "highest runs them in full float32")
    p.add_argument("--fused-style-bwd",
                   action=argparse.BooleanOptionalAction, default=None,
                   help="style loss with the closed-form backward "
                        "(default on)")
    p.add_argument("--nan-checks", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="raise on non-finite loss at chunk boundaries "
                        "(default on)")
    p.add_argument("--stop-tol", type=float, default=None,
                   help="end the run once the relative loss change over a "
                        "chunk is <= this (default 0 = run every step)")
    p.add_argument("--lbfgs-history", type=int, default=None,
                   help=f"L-BFGS memory pairs (default {d.lbfgs_history})")
    p.add_argument("--lbfgs-max-ls-steps", type=int, default=None,
                   help="strong-Wolfe line-search eval budget per step "
                        f"(default {d.lbfgs_max_ls_steps})")
    p.add_argument("--lbfgs-direction", choices=["matrix", "loop"],
                   default=None, help="two-loop recursion form")
    p.add_argument("--lbfgs-t-init", choices=["lr", "unit"], default=None,
                   help="line search's first trial step: lr = torch parity; "
                        "unit = t=1 once history exists")
    p.add_argument("--lbfgs-grams", choices=["recompute", "incremental"],
                   default=None,
                   help="matrix direction's S Yᵀ / Y Yᵀ: recompute every "
                        "step, or carry them in the optimizer state and "
                        "refresh one row and column per stored pair")
    p.add_argument("--lbfgs-state-dtype", choices=["float32", "bfloat16"],
                   default=None,
                   help="storage dtype of the (m, n) L-BFGS history: "
                        "float32 (default) or bfloat16 (pairs quantised "
                        "when stored, float32 accumulation; halves the "
                        "history's memory)")
    p.add_argument("--lr-start", type=float, default=None,
                   help=f"initial learning rate (default {d.lr_start})")
    p.add_argument("--lr-decay", type=float, default=None,
                   help=f"per-step lr decay factor (default {d.lr_decay})")
    p.add_argument("--lr-decay-per-eval",
                   action=argparse.BooleanOptionalAction, default=None,
                   help="decay lr per loss evaluation like the reference "
                        "(default on)")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--demo-normal-noise", action="store_true", default=None,
                   help="ablation: normal noise instead of style-pixel noise")
    p.add_argument("--demo-no-gaussian-mask", action="store_true",
                   default=None,
                   help="ablation: skip the Gaussian noise envelopes")
    p.add_argument("--demo-ignore-gradient-map", action="store_true",
                   default=None,
                   help="ablation: constant noise weight (no Sobel map)")
    p.add_argument("--dump-masks", default=None, metavar="DIR",
                   help="dump noise/gradient mask JPEGs for inspection")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m artstyletransfer_tpu_torch.frontends.cli",
        description="Neural style transfer on CUDA (pyramid Gatys + "
                    "structured noise init)")
    p.add_argument("--content", required=True, help="content image path")
    p.add_argument("--style", required=True, help="style image path")
    p.add_argument("--output", required=True, help="output JPEG path")
    add_engine_flags(p)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the job runs (default cuda)")
    p.add_argument("--weights", default=None,
                   help="VGG19 weights (.npz, torchvision .pth or "
                        "Keras .h5); default: env ASTT_VGG19_WEIGHTS, the "
                        "weights cache, or the seeded init")
    p.add_argument("--save-progress", action="store_true",
                   help="also save intermediate images next to the output")
    p.add_argument("--verbose-losses", action="store_true",
                   help="print per-level loss components at each progress "
                        "update")
    p.add_argument("--metrics", default=None, metavar="PATH",
                   help="append per-progress JSONL metrics to PATH")
    p.add_argument("--profile-trace", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace of the run "
                        "to DIR")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint file; combine with --checkpoint-every "
                        "and --resume")
    p.add_argument("--checkpoint-every", type=int, default=None,
                   help="steps between checkpoints (default: "
                        "--stream-every)")
    p.add_argument("--resume", action="store_true",
                   help="resume from --checkpoint if it exists")
    p.add_argument("--quiet", action="store_true")
    return p


_FLAG_FIELDS = {
    "optimizer": "optimizer", "init_method": "init_method",
    "use_relu": "use_relu",
    "levels": "levels_num", "iters": "iters_num",
    "content_weight": "content_weight", "style_weight": "style_weight",
    "tv_weight": "tv_weight", "noise_factor": "noise_factor",
    "base_diameter": "base_diameter", "stream_every": "stream_every",
    "compute_dtype": "compute_dtype", "conv_precision": "conv_precision",
    "fused_style_bwd": "fused_style_bwd", "nan_checks": "nan_checks",
    "stop_tol": "stop_tol",
    "lbfgs_history": "lbfgs_history",
    "lbfgs_max_ls_steps": "lbfgs_max_ls_steps",
    "lbfgs_direction": "lbfgs_direction",
    "lbfgs_t_init": "lbfgs_t_init",
    "lbfgs_grams": "lbfgs_grams",
    "lbfgs_state_dtype": "lbfgs_state_dtype",
    "lr_start": "lr_start", "lr_decay": "lr_decay",
    "lr_decay_per_eval": "lr_decay_per_eval",
    "seed": "seed", "demo_normal_noise": "demo_normal_noise",
    "demo_no_gaussian_mask": "demo_no_gaussian_mask",
    "demo_ignore_gradient_map": "demo_ignore_gradient_map",
    "dump_masks": "dump_masks_dir",
}


def config_from_args(args: argparse.Namespace) -> Config:
    """The preset, then the flags, then production_config for the run's
    device; an explicit --lbfgs-grams (the field production_config sets)
    wins over it."""
    cfg = PRESETS[args.preset] if args.preset else Config()
    overrides = {field: getattr(args, flag)
                 for flag, field in _FLAG_FIELDS.items()
                 if getattr(args, flag) is not None}
    cfg = production_config(dataclasses.replace(cfg, **overrides),
                            device=args.device)
    if args.lbfgs_grams is not None:
        cfg = dataclasses.replace(cfg, lbfgs_grams=args.lbfgs_grams)
    return cfg


def _load_params(args):
    if not args.weights:
        return None
    from ..models.weights import load_vgg19_params

    return load_vgg19_params(args.weights)


def run_job_checkpointed(args: argparse.Namespace,
                         cfg: Config) -> np.ndarray:
    """TransferJob without the Executor: the path for --checkpoint (and
    --verbose-losses, which prints per-level losses)."""
    from ..engine.transfer import TransferJob
    from ..utils.metrics import MetricsLogger, Throughput

    job = TransferJob(load_image(args.content), load_image(args.style),
                      cfg, params=_load_params(args), device=args.device)
    img = None
    with MetricsLogger(args.metrics) as metrics:
        tp = Throughput()
        tp.tick(0)
        for done, img, loss in job.run(
                checkpoint_path=args.checkpoint,
                checkpoint_every=args.checkpoint_every or cfg.stream_every,
                resume=args.resume,
                report_level_losses=args.verbose_losses):
            sps = tp.tick(done)
            metrics.log("chunk", step=done, loss=float(loss),
                        steps_per_sec=round(sps, 4) if sps else None,
                        percent=done / cfg.iters_num * 100.0)
            if not args.quiet:
                print(f"step {done}/{cfg.iters_num} loss {loss:.4e}")
                for i, (lt, lc, ls, ltv) in enumerate(
                        job.last_level_losses or ()):
                    print(f" - level {i} | level loss={lt:.3e}, "
                          f"content_loss={cfg.content_weight * lc:.3e}, "
                          f"style loss={cfg.style_weight * ls:.3e}, "
                          f"tv loss={cfg.tv_weight * ltv:.3e}")
    return img


async def run_job(args: argparse.Namespace, cfg: Config) -> np.ndarray:
    from functools import partial

    from ..engine.transfer import neural_style_transfer
    from ..utils.metrics import MetricsLogger

    content = load_image(args.content)
    style = load_image(args.style)
    latest = {}

    async def report(task_id, result):
        percent, img = result
        latest["img"] = img
        if not args.quiet:
            print(f"[{task_id[:8]}] {percent:5.1f}%")
        if args.save_progress and img is not None:
            save_image(np.clip(img, 0, 1),
                       f"{args.output}.{percent:05.1f}.jpg")

    engine = partial(neural_style_transfer, params=_load_params(args))
    with MetricsLogger(args.metrics) as metrics:
        executor = Executor(cfg, report_progress=report, engine=engine,
                            verbose=not args.quiet,
                            metrics=metrics if args.metrics else None,
                            device=args.device)
        pair = ContentStylePair((args.content, content), (args.style, style))
        await executor.add_task(str(uuid.uuid4()), pair)
        await executor.run()
    if executor.failures:
        raise next(iter(executor.failures.values()))
    return latest.get("img")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    resolve_device(args.device)  # no card and no --device cpu: fail first
    cfg = config_from_args(args)
    if not args.quiet:
        print(f"config: optimizer={cfg.optimizer} levels={cfg.levels_num} "
              f"iters={cfg.iters_num} init={cfg.init_method} "
              f"base={cfg.base_diameter} device={args.device}")
    from ..utils.metrics import profile_trace

    t0 = time.time()
    with profile_trace(args.profile_trace):
        if args.checkpoint or args.verbose_losses:
            img = run_job_checkpointed(args, cfg)
        else:
            img = asyncio.run(run_job(args, cfg))
    if img is None:
        print("No output produced", file=sys.stderr)
        return 1
    save_image(np.clip(img, 0, 1), args.output)
    if not args.quiet:
        print(f"Done in {time.time() - t0:.1f}s -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
