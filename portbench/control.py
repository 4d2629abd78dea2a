"""The readings that a cell's correctness limits are set from.

  python3 portbench/control.py --workload NAME --seeds 1,2,... \
      --control-seeds 101,102,103 [--seconds S] [--out FILE] \
      [--fields JSON] [--traffic JSON]

In one process (the set-up is paid once): a short window of the cell on
each of --seeds as the configuration states it (the sound readings), and
on each of --control-seeds with the program's own lower-precision path
switched on (compute_dtype 'bfloat16' for a float32 configuration: the
control). Prints every run's compared numbers and, per number, the lower
reading (the largest of the sound runs) and the upper (the smallest of
the control's). A limit is set between the two by hand, in the cell's
file; the benchmark's own runs never run this. --fields and --traffic
replace configuration fields and traffic keys, for the readings at the
reduced size of the card test (tests/test_portbench_traffic.py).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import run as bench  # noqa: E402

CONTROL = {"compute_dtype": "bfloat16"}


def release():
    """Drop the program's captured evaluations and weight copies between
    runs: each seed has weights of its own, and one process holds every
    run's graphs otherwise."""
    import gc

    import torch

    from artstyletransfer_tpu_torch.engine import transfer
    from artstyletransfer_tpu_torch.models import weights

    transfer._COMPILE_CACHE.clear()
    weights._SHARED.clear()
    gc.collect()
    torch.cuda.empty_cache()


def readings(cell, seeds, overrides, seconds, device, fields=None):
    out = []
    for seed in seeds:
        release()
        result = bench.run_cell(cell, seed, seconds, False,
                                {**(fields or {}), **overrides}, device)
        row = {"seed": seed, "overrides": overrides or None,
               "correct": None if result is None else result["correct"],
               "check": None if result is None else {
                   k: v["value"] for k, v in result["check"].items()}}
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


def summary(sound, control):
    names = sorted({k for r in sound + control for k in (r["check"] or {})})
    table = {}
    for k in names:
        lo = [r["check"][k] for r in sound if r["check"] and k in r["check"]]
        hi = [r["check"][k] for r in control
              if r["check"] and k in r["check"]]
        table[k] = {"lower": max(lo, default=None),
                    "upper": min(hi, default=None),
                    "sound": lo, "control": hi}
    return table


def main(argv=None) -> int:
    from portbench.harness.spec import load_cell

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--fields", default="{}")
    ap.add_argument("--traffic", default="{}")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    cell = load_cell(args.workload, ROOT)
    cell = dataclasses.replace(
        cell, traffic={**cell.traffic, **json.loads(args.traffic)})
    fields = json.loads(args.fields)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    cseeds = [int(s) for s in args.control_seeds.split(",") if s]
    sound = readings(cell, seeds, {}, args.seconds, "cuda:0", fields)
    control = readings(cell, cseeds, CONTROL, args.seconds, "cuda:0",
                       fields)
    table = summary(sound, control)
    print(json.dumps({"workload": cell.name, "readings": table}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump({"workload": cell.name, "sound": sound,
                       "control": control, "readings": table}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
