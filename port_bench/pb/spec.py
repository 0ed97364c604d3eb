"""What a run reads, found by name: the cell in `BENCHMARK.json`, its
configuration, its traffic mix, its comparison limits and its metrics.

  - a configuration: the `file` of its entry in `configs` (by convention
    `configs/<name>.json`);
  - a traffic mix: `traffic/<name>.json`;
  - a cell's comparison limits: `cells/<cell>.json`;
  - a metric: `metrics/<name>.py`, a module with `read(run)` that returns
    the metric's value, or None where it finds nothing to read.

A new configuration, mix, cell or metric is new files and entries; no
file of the benchmark changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)


@dataclass
class Cell:
    name: str
    config: dict  # the configuration's file, with "name"
    mix: dict  # the traffic mix
    limits: dict  # cells/<cell>.json
    chips: int
    metrics: list  # entries of BENCHMARK.json reported by this cell's run
    repo: str
    bench: str


def load_cell(workload: str, trace: bool, repo: str = REPO, bench: str = BENCH) -> Cell:
    from . import check, traffic

    with open(os.path.join(repo, "BENCHMARK.json")) as fd:
        spec = json.load(fd)
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[workload]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    with open(os.path.join(repo, cfg_entry["file"])) as fd:
        config = dict(json.load(fd), name=cfg_entry["name"])
    mix = traffic.load_mix(os.path.join(bench, "traffic", f"{w['traffic']}.json"))
    limits = check.load_limits(os.path.join(bench, "cells", f"{workload}.json"))
    if trace:
        metrics = [m for m in spec["per_layer"] if workload in m.get("workloads", [workload])]
    else:
        metrics = [m for m in spec["end_to_end"] if workload in m.get("workloads", [workload])]
    return Cell(workload, config, mix, limits, int(w["chips"]), metrics, repo, bench)


def reader(bench: str, name: str):
    """The `read` function of metrics/<name>.py."""
    path = os.path.join(bench, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"pb_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
