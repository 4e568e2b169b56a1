"""Sweep-engine benchmark: the cold and warm study grid, and its launch
contract.

The port of ``benchmarks/sweep_bench.py``. It runs the paper machine set
x benchmarks through ``sweep.run_sweep_with_stats`` on the device and
reports:

* ``trace_build`` — phase 1 of the two-phase expansion alone: one
  ThreadTrace build per (bench, n_threads, seed) of the grid.
* ``cold`` — the cold path: trace families (one ThreadTrace per
  workload, shared by every expansion key) + per-key aggregation (the C
  core) + one K2 launch a trace family, fresh (empty) cache and LRUs.
* ``warm`` — the same sweep again over the now-populated cache.

Each timing is the minimum of two repetitions from scratch (a fresh cache
directory, fresh LRUs). Counter rows carry the reference's names and
values: the ResultCache hits and misses and the trace/expansion grouping
of the cold and warm runs; two more count the family launches of each.

Asserted, the launch contract: the cold run makes one
``ws_family_kernel`` launch a trace family (on the card, read from the
kernel's launch counter; on the CPU, from the run's ``family_launches``),
the warm run none, and every record of both equals, bit for bit, the same
grid computed through ``engine="torch"`` (the plain versions, on the
host CPU).

The reference's ``serial_event``, ``cold_pr1``, ``cold_pr2`` and
``cold_pallas`` phases and their speedup floors are left out: their
baselines are engines and process-pool paths the port does not have. So
is the reference's ``BENCH_PR6.json`` trajectory entry.

Rows follow the harness CSV convention ``(name, us_per_call, derived)``:
`derived` is 1 for ``cold`` (the baseline), the speedup over cold for
``warm``, and the share of cold for ``trace_build`` (the reference's
formula); counter rows carry the raw count (``us_per_call`` = 0).

    PYTHONPATH=src python -m repro_torch.benchmarks.sweep_bench [--quick] [--json [PATH]] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import tempfile
import time
from typing import List, Tuple

from repro_torch.core.warpsim import _cuda, machines, sweep
from repro_torch.core.warpsim.divergence import build_thread_trace
from repro_torch.core.warpsim.trace import BENCHMARKS, get_workload
from repro_torch.models.model import resolve_device

Row = Tuple[str, float, float]

QUICK_BENCHES = ("BFS", "BKP", "MTM", "DYN")
QUICK_N_THREADS = 512
REPS = 2
JSON_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                         "..", "..", "benchmarks", "results", "torch",
                         "sweep_bench.json")


def _records(results) -> dict:
    return {(m, b): dataclasses.asdict(r)
            for m, per in results.items() for b, r in per.items()}


def run(quick: bool = False, device="cuda") -> List[Row]:
    device = resolve_device(device)
    on_card = device.type == "cuda"
    benches = QUICK_BENCHES if quick else BENCHMARKS
    n_threads = QUICK_N_THREADS if quick else None
    spec = sweep.SweepSpec(machines=machines.paper_suite(),
                           benches=tuple(benches), n_threads=n_threads)

    t_trace = float("inf")
    for _ in range(REPS):
        t0 = time.time()
        for b in benches:
            build_thread_trace(get_workload(b, n_threads=n_threads))
        t_trace = min(t_trace, time.time() - t0)

    t_cold = float("inf")
    cache_dir = None
    try:
        for _ in range(REPS):
            if cache_dir is not None:
                shutil.rmtree(cache_dir, ignore_errors=True)
            cache_dir = tempfile.mkdtemp(prefix="warpsim-sweep-bench-")
            _cuda.reset_launch_counts()
            t0 = time.time()
            cold, cold_stats = sweep.run_sweep_with_stats(
                spec, cache=sweep.ResultCache(cache_dir), device=device)
            t_cold = min(t_cold, time.time() - t0)
            cold_launches = _cuda.launch_count("ws_family_kernel")

        warm_cache = sweep.ResultCache(cache_dir)
        _cuda.reset_launch_counts()
        t0 = time.time()
        warm, warm_stats = sweep.run_sweep_with_stats(spec, cache=warm_cache,
                                                      device=device)
        t_warm = time.time() - t0
        warm_launches = _cuda.launch_count("ws_family_kernel")
    finally:
        if cache_dir is not None:
            shutil.rmtree(cache_dir, ignore_errors=True)

    n_families = len(benches) * len(spec.seeds)
    if not on_card:                # the plain versions count no launch
        cold_launches = cold_stats["family_launches"]
        warm_launches = warm_stats["family_launches"]
    if cold_launches != n_families or cold_stats["family_launches"] \
            != n_families:
        raise AssertionError(
            f"cold run: {cold_launches} ws_family_kernel launches "
            f"(stats {cold_stats['family_launches']}) for {n_families} "
            f"trace families")
    if warm_launches or warm_stats["simulated"]:
        raise AssertionError(
            f"warm run launched {warm_launches} and simulated "
            f"{warm_stats['simulated']}")
    want = _records(cold if not on_card else sweep.run_sweep(
        spec, device="cpu", engine="torch"))
    for name, got in (("cold", cold), ("warm", warm)):
        if _records(got) != want:
            raise AssertionError(f"{name} records differ from the grid "
                                 f"through engine='torch'")
    n_cells = len(want)
    if warm_cache.hits != n_cells or warm_stats["cache_hits"] != n_cells \
            or cold_stats["cache_misses"] != n_cells \
            or cold_stats["trace_families"] != len(benches):
        raise AssertionError(f"cache counters: cold {cold_stats}, warm "
                             f"{warm_stats}")

    return [
        ("sweep/trace_build", t_trace * 1e6, t_trace / max(t_cold, 1e-9)),
        ("sweep/cold", t_cold * 1e6, 1.0),
        ("sweep/warm", t_warm * 1e6, t_cold / max(t_warm, 1e-9)),
        ("sweep/cold_cells", 0.0, float(cold_stats["cells"])),
        ("sweep/cold_cache_misses", 0.0, float(cold_stats["cache_misses"])),
        ("sweep/cold_trace_families", 0.0,
         float(cold_stats["trace_families"])),
        ("sweep/cold_traces_shared", 0.0, float(cold_stats["traces_shared"])),
        ("sweep/cold_expansion_groups", 0.0,
         float(cold_stats["expansion_groups"])),
        ("sweep/cold_expansions_saved", 0.0,
         float(cold_stats["expansions_saved"])),
        ("sweep/cold_family_launches", 0.0, float(cold_launches)),
        ("sweep/warm_cache_hits", 0.0, float(warm_stats["cache_hits"])),
        ("sweep/warm_cache_misses", 0.0, float(warm_stats["cache_misses"])),
        ("sweep/warm_family_launches", 0.0, float(warm_launches)),
    ]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--quick", action="store_true",
                    help="reduced grid (CI smoke): 4 benches, 512 threads")
    ap.add_argument("--json", nargs="?", const=JSON_PATH, default=None,
                    metavar="PATH",
                    help="also dump the rows as JSON (default path "
                         "benchmarks/results/torch/sweep_bench.json)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)

    rows = run(quick=args.quick, device=args.device)
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived:.6g}")
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump([{"name": n, "us_per_call": us, "derived": d}
                       for n, us, d in rows], f, indent=1)


if __name__ == "__main__":
    main()
