"""Find the highest arrival rate a served cell sustains: one sweep.

  python3 portbench/sweep.py --workload NAME --rates 0.05,0.08,... \
      [--seconds S] [--seed N] [--out FILE]

Runs the cell once at each rate, in one process (the set-up is paid
once), and prints per rate the offered and completed job-steps per
second, the progress gaps' tail and the backlog at the close (jobs due
in the window that had not delivered an image by then). The knee is the highest
rate whose backlog does not grow and whose completed work keeps up with
the offered; the cell's file then carries a fixed rate below it. The
benchmark's own runs never sweep.
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


def main(argv=None) -> int:
    from portbench.harness.spec import load_cell

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("sweep: no CUDA card", file=sys.stderr)
        return 2
    cell = load_cell(args.workload, ROOT)
    rows = []
    for rate in (float(r) for r in args.rates.split(",")):
        c = dataclasses.replace(cell, traffic={**cell.traffic, "rate": rate})
        result = bench.run_cell(c, args.seed, args.seconds, False, {},
                                "cuda:0")
        m = {k: v["value"] for k, v in result["metrics"].items()}
        row = {"rate": rate,
               "offered_steps_per_s": rate * cell.fields["iters_num"],
               "completed_steps_per_s": m.get("served_steps_per_s"),
               "progress_gap_p95_s": m.get("progress_gap_p95_s"),
               "attempted": result["attempted"],
               "failed": result["failed"], "correct": result["correct"],
               "backlog_at_close": result["notes"].get("backlog_at_close")}
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(rows, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
