"""What a cell is made of, found by name.

``BENCHMARK.json`` names each workload's configuration and traffic mix;
``configs/<config>.json`` holds the configuration as it is run (its
``fields`` are the port's ``Config`` fields), ``traffic/<traffic>.json``
the mix's parameters and the ``entry`` module that drives it
(``traffic/<entry>.py``), ``cells/<workload>.json`` what the correctness
check samples and its limits, and ``metrics/<metric>.py`` the reader of
each metric. A new cell, configuration, mix or metric is new files and
new entries in ``BENCHMARK.json``; nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Any, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_json(path: str) -> Any:
    with open(path) as fh:
        return json.load(fh)


def load_module(kind: str, name: str, bench_dir: str = BENCH_DIR):
    """The module ``<bench_dir>/<kind>/<name>.py``, loaded by path (names
    may hold '-' and '.')."""
    path = os.path.join(bench_dir, kind, f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind} module {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name}".replace("-", "_").replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    """One workload of BENCHMARK.json with everything it names."""

    name: str
    chips: int
    config: Dict[str, Any]       # configs/<config>.json
    traffic: Dict[str, Any]      # traffic/<traffic>.json
    check: Dict[str, Any]        # cells/<workload>.json
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    run_seconds: int
    bench_dir: str = BENCH_DIR   # where its traffic and metric modules are

    @property
    def fields(self) -> Dict[str, Any]:
        """The Config fields the cell runs with."""
        return self.config["fields"]


def _metrics_of(entries, workload: str):
    return [m for m in entries
            if "workloads" not in m or workload in m["workloads"]]


def load_cell(workload: str, root: str,
              bench_dir: Optional[str] = None) -> Cell:
    """The cell `workload` of ``<root>/BENCHMARK.json``."""
    bench_dir = bench_dir or BENCH_DIR
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"]
                     if c["name"] == entry["config"])
    config = _load_json(os.path.join(root, cfg_entry["file"]))
    traffic = _load_json(os.path.join(bench_dir, "traffic",
                                      f"{entry['traffic']}.json"))
    check = _load_json(os.path.join(bench_dir, "cells", f"{workload}.json"))
    return Cell(name=workload, chips=int(entry["chips"]), config=config,
                traffic=traffic, check=check,
                end_to_end=_metrics_of(bench["end_to_end"], workload),
                per_layer=_metrics_of(bench["per_layer"], workload),
                run_seconds=int(bench["run_seconds"]), bench_dir=bench_dir)
