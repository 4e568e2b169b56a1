"""Roofline table rows from the dry run's results.

The port of ``benchmarks/roofline_table.py``, reading the port's dry run
(``python -m repro_torch.launch.dryrun``), whose results file is
``benchmarks/results/torch/dryrun.json``. The roofline terms use the
H100 constants of ``repro_torch.roofline.report``.
"""

from __future__ import annotations

import json
import os
from typing import List, Tuple

from repro_torch.launch.dryrun import RESULTS

Row = Tuple[str, float, float]


def load() -> dict:
    if not os.path.exists(RESULTS):
        return {}
    with open(RESULTS) as f:
        return json.load(f)


def run() -> List[Row]:
    rows: List[Row] = []
    data = load()
    if not data:
        rows.append(("roofline/missing-run-dryrun-first", 0.0, 0.0))
        return rows
    for key, v in sorted(data.items()):
        if v.get("status") != "ok":
            continue
        r = v["roofline"]
        cell = key.replace("|", "/")
        rows.append((f"roofline/{cell}/compute_s",
                     v["compile_s"] * 1e6, r["compute_s"]))
        rows.append((f"roofline/{cell}/memory_s", 0.0, r["memory_s"]))
        rows.append((f"roofline/{cell}/collective_s", 0.0,
                     r["collective_s"]))
        rows.append((f"roofline/{cell}/fraction", 0.0,
                     r["roofline_fraction"]))
    return rows


def table(mesh: str = "pod16x16") -> str:
    data = load()
    lines = [f"{'arch':24s} {'shape':12s} {'comp_s':>9s} {'mem_s':>9s} "
             f"{'coll_s':>9s} {'dominant':>10s} {'useful':>7s} {'frac':>7s}"]
    for key, v in sorted(data.items()):
        if v.get("status") != "ok":
            continue
        r = v["roofline"]
        if r["mesh"] != mesh:
            continue
        lines.append(
            f"{r['arch']:24s} {r['shape']:12s} {r['compute_s']:9.4f} "
            f"{r['memory_s']:9.4f} {r['collective_s']:9.4f} "
            f"{r['dominant']:>10s} {r['useful_flops_ratio']:7.3f} "
            f"{r['roofline_fraction']:7.4f}")
    return "\n".join(lines)


if __name__ == "__main__":
    print(table())
