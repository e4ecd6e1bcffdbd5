"""The harness: one run of one cell, found by name.

    files = Files(<port_bench directory>)
    result = run_cell(files, "finetune.cached", seed, seconds, trace, device)

Everything that belongs to one configuration, one cell or one per-layer
metric is a file of its own, found by its name:
  configs/<config>.json      the configuration's sizes
  workloads/<cell>.json      the cell: configuration, entry, traffic, limits
  entries/<entry>.py         set-up, the timed loop and the check's inputs
  metrics/<metric>.py        one per-layer metric's reader: read(ctx) -> value or None
`BENCHMARK.json` (at the root of the checkout) names the metrics a cell
reports; adding a cell or a metric adds files and entries, and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
import time
from types import ModuleType
from typing import Any, Dict, Optional

# compared whole, as the part of a module's name before the first dot
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "macsa_tpu")


@dataclasses.dataclass
class Files:
    root: str  # the port_bench directory

    def json(self, kind: str, name: str) -> dict:
        with open(os.path.join(self.root, kind, f"{name}.json")) as f:
            return json.load(f)

    def module(self, kind: str, name: str) -> ModuleType:
        path = os.path.join(self.root, kind, f"{name}.py")
        spec = importlib.util.spec_from_file_location(f"port_bench_{kind}_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod


@dataclasses.dataclass
class Ctx:
    """What an entry gets: the cell, its configuration and the run's knobs."""
    name: str
    workload: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: Any
    started: float  # time.perf_counter() at the process's start


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN_MODULES))


def metric_names(benchmark: dict, cell: str, trace: bool) -> list:
    """The metrics `cell` reports in this mode, from BENCHMARK.json."""
    group = benchmark["per_layer" if trace else "end_to_end"]
    return [m for m in group if "workloads" not in m or cell in m["workloads"]]


def run_cell(files: Files, benchmark: dict, cell: str, seed: int, seconds: float,
             trace: bool, device, started: Optional[float] = None) -> dict:
    """One run -> the result line's object (see `result_line`)."""
    started = time.perf_counter() if started is None else started
    workload = files.json("workloads", cell)
    config = files.json("configs", workload["config"])
    ctx = Ctx(cell, workload, config, seed, seconds, trace, device, started)
    out = files.module("entries", workload["entry"]).run(ctx)
    metrics = {}
    for m in metric_names(benchmark, cell, trace):
        if trace:
            value = files.module("metrics", m["name"]).read(out["readers"])
        else:
            value = out["end_to_end"].get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": out["device"], "breakdown": out.get("breakdown"),
            "check": out["check"], "notes": out.get("notes", {})}


def result_line(result: dict, trace: bool) -> str:
    """The last line of standard output; the numbers compared come last."""
    line: Dict[str, Any] = {k: result[k] for k in
                            ("correct", "attempted", "failed", "metrics", "device")}
    if trace and result.get("breakdown"):
        line["breakdown"] = result["breakdown"]
    line["check"] = result["check"]
    return json.dumps(line)
