"""Run one cell of the port's benchmark and print its result line.

  python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. The cell's configuration, traffic and
metrics are found by name (portbench/harness/spec.py). The run makes its
weights and images from the seed, builds what the program needs, warms
the cell's own shapes, measures a window of S seconds (--trace 1: the
per-layer metrics, with the whole window profiled), then checks the
program's answers against the plain reference (portbench/reference).
The last line of standard output is one JSON object; the numbers
compared, each beside its limit, are the last lines of standard error.
The run exits non-zero, and prints no result, without CUDA or enough
cards, when the program cannot be imported, or when JAX or the JAX
package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the program's JIT and extension caches, at fixed paths in the checkout
CACHE = os.path.join(ROOT, ".portbench_cache")
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      os.path.join(CACHE, "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
os.environ.setdefault("USE_FLAX", "0")
# the port's serving mesh is the cell's to choose; one process per card
os.environ["ASTT_SERVING_MESH"] = "none"

FORBIDDEN = ("jax", "jaxlib", "flax", "artstyletransfer_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's (the port's name begins with the latter's, so a prefix
    match would be wrong)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def card_info(chips: int) -> dict:
    import torch

    out = {"kind": torch.cuda.get_device_name(0), "count": chips,
           "visible": torch.cuda.device_count()}
    try:
        out["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        out["nvidia_smi"] = f"unavailable: {e}"
    return out


def build_program() -> dict:
    """Build (or find built) the port's CUDA kernels and native library,
    timed: a fresh checkout compiles here, a warm one reuses them."""
    from artstyletransfer_tpu_torch import native
    from artstyletransfer_tpu_torch.kernels import build

    t0 = time.perf_counter()
    built = build.build_all()
    t1 = time.perf_counter()
    native_ok = native.available()
    t2 = time.perf_counter()
    return {"kernels_s": t1 - t0, "kernels_compiled": sorted(built),
            "native_s": t2 - t1, "native": native_ok}


class Readings:
    """What a metric's reader (metrics/<name>.py: read(readings)) gets."""

    def __init__(self, cell, record, recorder, trace):
        from portbench.yardstick import counts, peaks

        self.cell = cell
        self.fields = cell.fields
        self.traffic = cell.traffic
        self.record = record
        self.recorder = recorder
        self.trace = trace
        self.evaluation = counts.evaluation(self.fields)
        self.peak_ops = peaks.peak_ops(self.fields)
        self.bytes_per_s = peaks.hbm_bytes_per_s()

    def least(self, calls) -> float:
        from portbench.yardstick import counts

        return counts.least_seconds(calls, self.peak_ops, self.bytes_per_s)

    def lane_evals(self, launches) -> float:
        """Lane evaluations in a span, from its TV forward launches: one
        per level and round (two with remat_levels), every lane of the
        traffic's batch in each round."""
        per_round = int(self.fields["levels_num"]) * (
            2 if self.fields.get("remat_levels") else 1)
        return (launches.get("tv", 0) / per_round
                * int(self.traffic.get("lanes", 1)))


def read_metrics(names, readings) -> dict:
    from portbench.harness.spec import load_module

    out = {}
    for m in names:
        value = load_module("metrics", m["name"],
                            readings.cell.bench_dir).read(readings)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench.harness.spec import load_cell

    cell = load_cell(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " visible", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), {},
                      "cuda:0")
    if result is None:
        return 3
    print(json.dumps(result))
    return 0


def run_cell(cell, seed: int, seconds: float, trace: bool, overrides: dict,
             device: str):
    """Run the cell once; the result object, or None when the run loaded
    what it must not. overrides: Config fields to replace (the control
    readings of control.py; a benchmark run passes none)."""
    import dataclasses

    import torch

    from artstyletransfer_tpu_torch.config import Config
    from portbench.harness import inputs
    from portbench.harness.check import run_check
    from portbench.harness.entry import Context
    from portbench.harness.record import Recorder
    from portbench.harness.session import Session
    from portbench.harness.spec import load_module
    from portbench.harness.trace import optional_parse

    fields = {**cell.fields, **overrides}
    cell = dataclasses.replace(cell, config={**cell.config, "fields": fields})
    on_card = torch.device(device).type == "cuda"
    setup = {"cell": cell.name, "seed": seed, "seconds": seconds,
             "overrides": overrides or None}
    if on_card:
        setup.update(build=build_program(), card=card_info(cell.chips))
    print(json.dumps({"setup": setup}), file=sys.stderr, flush=True)

    cfg = Config(**{k: tuple(v) if isinstance(v, list) else v
                    for k, v in fields.items()})
    params = inputs.weights(seed, device)
    session = Session(seconds, trace, T_START)
    recorder = Recorder()
    ctx = Context(cfg=cfg, fields=fields, traffic=cell.traffic,
                  params=params, seed=seed, device=device, session=session,
                  recorder=recorder)
    record = load_module("traffic", cell.traffic["entry"],
                         cell.bench_dir).run(ctx)
    peak = max(record.peak_setup_bytes, record.peak_window_bytes)
    trace_data = optional_parse(session.tracer)
    readings = Readings(cell, record, recorder, trace_data)
    metrics = read_metrics(cell.per_layer if trace else cell.end_to_end,
                           readings)

    notes = dict(record.notes)
    if trace and on_card:
        notes["memory_stats"] = memory_prediction(cfg, cell, device)
    import gc

    del ctx
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    correct, table, rows = run_check(
        record, fields, params, cell.check.get("limits", {}),
        int(cell.check.get("jobs", 3)), seed, device)
    notes["check_s"] = time.perf_counter() - t_check
    print(json.dumps({"notes": notes, "check_rows": rows}), file=sys.stderr)
    for name, (value, limit) in table.items():
        print(f"check {name} {value!r} limit "
              f"{'none' if limit is None else repr(limit)}", file=sys.stderr)
    result = {
        "correct": bool(correct and record.failed == 0),
        "attempted": int(record.attempted),
        "failed": int(record.failed),
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(0) if on_card
                            else "cpu"),
                   "count": cell.chips, "memory_peak_bytes": int(peak)},
    }
    if trace_data is not None:
        result["device"].update(busy_s=trace_data.busy_s,
                                window_s=trace_data.window_s)
        result["breakdown"] = {"device_ops": trace_data.top_device_ops(),
                               "idle_gaps": trace_data.idle_gaps()}
    result["notes"] = notes
    result["check"] = {k: {"value": v, "limit": lim}
                       for k, (v, lim) in table.items()}
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded {', '.join(found)}: the benchmark runs "
              "the port alone", file=sys.stderr)
        return None
    return result


def memory_prediction(cfg, cell, device) -> dict:
    """parallel/memory.py's prediction for the cell's batch (printed
    only; the metric is the measured peak)."""
    from artstyletransfer_tpu_torch.parallel.memory import memory_stats

    side = cell.fields["base_diameter"] * 2 ** (cell.fields["levels_num"] - 1)
    try:
        stats = memory_stats(cfg, (side, side),
                             int(cell.traffic.get("lanes", 1)),
                             device=device, limit_bytes=1)
    except Exception as e:  # noqa: BLE001 — a printed prediction only
        return {"error": f"{type(e).__name__}: {e}"}
    return {k: v for k, v in stats.items()
            if isinstance(v, (int, float)) or v is None}


if __name__ == "__main__":
    sys.exit(main())
