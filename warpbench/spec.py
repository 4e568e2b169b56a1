"""Find a cell's pieces by name: its entry in ``BENCHMARK.json``, its
configuration file, its traffic file and the reader of each metric.

A cell ``<config>.<traffic>`` names a configuration (the file that
``BENCHMARK.json`` gives it) and a traffic mix
(``warpbench/traffic/<traffic>.json``); a metric ``<name>`` is read by
``warpbench/metrics/<name>.py``. Adding a cell or a metric is adding
files and entries: nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: List[dict]      # the cell's end-to-end metrics
    per_layer: List[dict]       # the cell's per-layer metrics


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, bench: Optional[dict] = None,
              root: Path = ROOT) -> Cell:
    """The cell `name` of `bench` (``BENCHMARK.json`` when omitted), its
    files read. Raises KeyError for a cell the benchmark does not have."""
    bench = load_benchmark(root) if bench is None else bench
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r}; have {sorted(by_name)}")
    w = by_name[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(root / cfg["file"]) as f:
        config = json.load(f)
    with open(root / HERE.name / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    layer = [m for m in bench["per_layer"] if _reports(m, name)
             and any(e["name"] == m["moves"] for e in e2e)]
    return Cell(name, config, traffic, int(w["chips"]), e2e, layer)


def reader(metric: str) -> Callable:
    """The ``read(run)`` function of ``warpbench/metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"warpbench_metric_{metric.replace('.', '_').replace('-', '_')}",
        path)
    if spec is None:
        raise FileNotFoundError(f"no reader for metric {metric!r} at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(metrics: List[dict], run) -> Dict[str, dict]:
    """``{name: {"value", "unit"}}`` of each metric whose reader finds
    something to read in `run` (a reader that finds nothing returns
    None, and the metric is left out)."""
    out = {}
    for m in metrics:
        value = reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
