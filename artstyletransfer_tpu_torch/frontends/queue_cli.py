"""Headless batch frontend: run a job queue through the policy-routed,
shape-bucketed batched path on the card.

The port of the JAX package's ``astt-queue`` (frontends/queue_cli.py):
``parallel.run_job_queue`` with shape bucketing, the per-optimizer
batching policy ('auto' batches Adam, reference-semantics L-BFGS and
unit-opening L-BFGS, runs lr-opening full-Wolfe L-BFGS one job at a time),
memory-aware group splitting and per-group failure isolation:

  python -m artstyletransfer_tpu_torch.frontends.queue_cli \\
      --manifest jobs.jsonl --output-dir out/
  python -m artstyletransfer_tpu_torch.frontends.queue_cli \\
      --pair bird.jpg vg.jpg --pair bird.jpg cubism.jpg \\
      --output-dir out/ --preset standard --device cpu

Manifest: JSONL, one job per line:
  {"id": "bird_vg", "content": "path/bird.jpg", "style": "path/vg.jpg"}
("id" optional — derived from the file stems and uniquified.)

Every engine/config flag of the port's CLI is accepted, plus --device
(default cuda; the run raises if no card is visible and --device cpu was
not given). --mesh auto (default) places each batch's jobs over every
visible card (parallel/mesh.py default_serving_mesh; a no-op on one card
and on the CPU, and the ASTT_SERVING_MESH=none environment variable
turns it off); --mesh none runs on one card. --space N (N > 1, with
--mesh auto) splits each job's rows over N cards (parallel/space.py):
the mesh is default_serving_mesh(N), and it exits with an error where
there is none (fewer than 2 cards, the CPU, or --mesh none).
--checkpoint-dir [--checkpoint-every N] [--resume] keeps
one checkpoint per group and resumes the same queue from them. Failed
jobs are reported on stderr and in the exit code;
completed images land in --output-dir/<id>.jpg. Reading and writing
images needs OpenCV (utils/image.py).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from ..config import resolve_device
from ..utils.image import load_image, save_image
from .cli import add_engine_flags, config_from_args


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m artstyletransfer_tpu_torch.frontends.queue_cli",
        description="Batch style transfer: a job queue through the "
                    "policy-routed, shape-bucketed batched path on CUDA")
    p.add_argument("--manifest", default=None,
                   help="JSONL file: {'id'?, 'content', 'style'} per line")
    p.add_argument("--pair", nargs=2, action="append", default=[],
                   metavar=("CONTENT", "STYLE"),
                   help="content/style image pair (repeatable)")
    p.add_argument("--output-dir", required=True,
                   help="directory for <id>.jpg results")
    add_engine_flags(p)
    p.add_argument("--batch-policy", default="auto",
                   choices=["auto", "batched", "sequential"],
                   help="'auto' (default) applies the per-optimizer "
                        "routing; see parallel/batch.py")
    p.add_argument("--max-batch", type=int, default=None,
                   help="cap jobs per batch (default: memory-aware)")
    p.add_argument("--mesh", default="auto", choices=["auto", "none"],
                   help="'auto' (default) batches jobs across every "
                        "visible card (no-op on one card and with --device "
                        "cpu); 'none' stays on one card. The "
                        "ASTT_SERVING_MESH env var can force 'none'.")
    p.add_argument("--space", type=int, default=1, metavar="N",
                   help="shard each job's pixels over N cards (HBM relief "
                        "for 2K/4-level jobs); needs --mesh auto and a "
                        "multiple of N cards")
    p.add_argument("--canonicalize-styles", action="store_true",
                   help="square styles to the base diameter so mixed "
                        "aspect ratios share one batch")
    p.add_argument("--canonicalize-contents", action="store_true",
                   help="crop contents to canonical aspect buckets "
                        "(bounds the number of batch shapes)")
    p.add_argument("--weights", default=None,
                   help="VGG19 weights (.npz, torchvision .pth or "
                        "Keras .h5); default: env ASTT_VGG19_WEIGHTS, the "
                        "weights cache, or the seeded init")
    p.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                   help="crash recovery: one checkpoint per group in DIR")
    p.add_argument("--checkpoint-every", type=int, default=None,
                   help="steps between checkpoints (default: "
                        "--stream-every)")
    p.add_argument("--resume", action="store_true",
                   help="resume the same queue from --checkpoint-dir")
    p.add_argument("--retries", type=int, default=0, metavar="N",
                   help="re-run a failed group up to N extra times")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the queue runs (default cuda)")
    p.add_argument("--metrics", default=None, metavar="PATH",
                   help="append per-chunk JSONL metrics to PATH")
    p.add_argument("--quiet", action="store_true")
    return p


def load_jobs(args: argparse.Namespace):
    """Returns (jobs, load_failures): (task_id, content, style) triples from
    --manifest + --pair, plus {task_id: exception} for jobs whose images
    failed to load.

    A missing or corrupt image file fails only that job instead of the
    whole queue. Malformed manifest structure (invalid JSON, missing keys)
    raises: that is a broken manifest, not a bad job."""
    specs = []
    if args.manifest:
        with open(args.manifest) as f:
            for line_no, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    row = json.loads(line)
                except json.JSONDecodeError as e:
                    raise ValueError(
                        f"{args.manifest}:{line_no}: invalid JSON: {e}"
                    ) from e
                if "content" not in row or "style" not in row:
                    raise ValueError(
                        f"{args.manifest}:{line_no}: need 'content' and "
                        f"'style' keys, got {sorted(row)}")
                specs.append((row.get("id"), row["content"], row["style"]))
    for content, style in args.pair:
        specs.append((None, content, style))
    if not specs:
        raise ValueError("no jobs: pass --manifest and/or --pair")

    def stem(path):
        return os.path.splitext(os.path.basename(path))[0]

    jobs, load_failures, used = [], {}, set()
    for tid, c_path, s_path in specs:
        if tid is None:
            tid = f"{stem(c_path)}__{stem(s_path)}"
        base, k = tid, 1
        while tid in used:
            k += 1
            tid = f"{base}_{k}"
        used.add(tid)
        try:
            jobs.append((tid, load_image(c_path), load_image(s_path)))
        except Exception as e:  # noqa: BLE001 — per-job isolation
            load_failures[tid] = e
    return jobs, load_failures


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.resume and not args.checkpoint_dir:
        parser.error("--resume requires --checkpoint-dir")
    if args.space > 1 and args.mesh != "auto":
        parser.error("--space > 1 requires --mesh auto")
    resolve_device(args.device)  # no card and no --device cpu: fail first
    cfg = config_from_args(args)

    jobs, load_failures = load_jobs(args)
    os.makedirs(args.output_dir, exist_ok=True)

    params = None
    if args.weights:
        from ..models.weights import load_vgg19_params
        params = load_vgg19_params(args.weights)

    from ..parallel import run_job_queue
    from ..parallel.mesh import serving_mesh
    from ..utils.metrics import MetricsLogger

    mesh = (serving_mesh(args.device, args.space) if args.mesh == "auto"
            else None)
    if args.space > 1 and mesh is None:
        parser.error(f"--space {args.space}: no mesh to shard over (it "
                     f"needs {args.space} or more visible cards; none on "
                     f"the CPU or with ASTT_SERVING_MESH=none)")
    if not args.quiet:
        where = (f"mesh={mesh.shape} over {mesh.size} cards"
                 if mesh is not None else f"device={args.device}")
        print(f"queue: {len(jobs)} jobs, policy={args.batch_policy}, "
              f"optimizer={cfg.optimizer}, levels={cfg.levels_num}, "
              f"iters={cfg.iters_num}, {where}")

    t0 = time.time()
    with MetricsLogger(args.metrics) as metrics:
        def report(tid, pct, img, loss):
            metrics.log("progress", task=tid, percent=pct, loss=loss)
            if not args.quiet:
                print(f"[{tid}] {pct:5.1f}% loss {loss:.3e}")

        results, failures = run_job_queue(
            jobs, cfg, params=params, progress=report,
            batch_policy=args.batch_policy, max_batch=args.max_batch,
            canonicalize_styles=args.canonicalize_styles,
            canonicalize_contents=args.canonicalize_contents,
            stream_images=False,  # final images only — no per-chunk copy
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_every=args.checkpoint_every, resume=args.resume,
            retries=args.retries, mesh=mesh,
            shard_space=args.space > 1 and mesh is not None,
            device=args.device)
        failures = {**load_failures, **failures}

        for tid, img in results.items():
            save_image(np.clip(img, 0, 1),
                       os.path.join(args.output_dir, f"{tid}.jpg"))
        for tid, exc in failures.items():
            print(f"FAILED {tid}: {type(exc).__name__}: {exc}",
                  file=sys.stderr)
            metrics.log("task_failed", task=tid)

    if not args.quiet:
        print(f"queue: {len(results)} done, {len(failures)} failed "
              f"in {time.time() - t0:.1f}s -> {args.output_dir}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
