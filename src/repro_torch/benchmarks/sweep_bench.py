"""Sweep-engine benchmark: the card's cold study against the reference's
host baselines, the warm study, and the launch contract.

The port of ``benchmarks/sweep_bench.py``. It runs the paper machine set
x benchmarks and reports, each phase the minimum of two repetitions (three
for the interleaved phases below, as in the reference) from scratch (a
fresh cache directory, fresh LRUs in the sweep and the process-global ones
cleared):

* ``serial_event`` — the event engine, serial, one cell a unit, no LRU
  (``runner.run_suite(engine="event", parallel=False,
  group_expansion=False, reuse_expansion=False)``).
* ``cold_pr1`` — the reference's first cold path: the ``fast_nested``
  engine, one single-phase expansion a cell, no LRU, in the process pool.
* ``cold_pr2`` — its second: the ``native`` engine over expansion-key
  groups, single-phase expansion per group (``share_traces=False``), in
  the process pool.
* ``trace_build`` — phase 1 of the two-phase expansion alone: one
  ThreadTrace build per (bench, n_threads, seed) of the grid.
* ``cold`` — the port's cold path (``engine="auto"``): trace families +
  per-key aggregation (the C core) + one K2 launch a trace family on the
  card; on ``--device cpu`` the plain versions instead.
* ``warm`` — the ``cold`` sweep again over its now-populated cache.
* ``cold_native`` — the reference's own current cold call
  (``engine="native"``, ``parallel=None``: the pool on a host with 4
  CPUs or more), where the reference has ``cold_pallas``: the card's
  study against the host C engine on the same host. Reported, never
  asserted.

``cold_pr2``, ``cold`` and ``cold_native`` are timed interleaved (each
repetition runs the three back to back), as the reference times its
``cold_pr2`` and ``cold``, so a noisy period on the host hits all three.
The pool starts its workers with ``forkserver`` (``sweep.pool_context``);
``pool_start`` is the time to start a pool and run one trivial task in
each worker, with the server already up.

The floors, with the reference's defaults: ``cold`` must beat
``cold_pr1`` by ``--min-speedup-pr1`` (2.5; 1.5 with ``--quick``),
``cold_pr2`` by ``--min-speedup-pr2`` (1.2; 1.1) and ``serial_event`` by
``--min-speedup-event`` (8; 3). A flag may raise its floor, never lower
it below that default. On the card they are asserted on
``cold``, as the reference asserts them on its ``cold``. With ``--device
cpu``, ``cold`` is the plain PyTorch versions, which were never meant to
be fast: there the floors are reported, not asserted, as the reference
reports its ``cold_pallas`` on a CPU.

Also asserted: every phase's records equal ``cold``'s, bit for bit, and
``cold``'s equal the grid through ``engine="torch"`` on the host CPU; the
cold run makes one ``ws_family_kernel`` launch a trace family (on the
card, read from the kernel's launch counter by delta, so a caller's
count goes on; on the CPU, from the run's
``family_launches``), the warm run none, and no host phase launches the
kernel. Counter rows carry the reference's
names and values: the ResultCache hits and misses and the trace/expansion
grouping of the cold and warm runs; two more count the family launches of
each, and ``pool_torch_workers`` counts the probed workers that hold
torch (0 unless the caller's main script imports it at its top level:
multiprocessing runs that script again in each worker). The reference's
``pallas_engine`` and ``pallas_family_launches``
rows have no counterpart (``cold_native`` takes ``cold_pallas``'s place),
and neither has its ``BENCH_PR6.json`` trajectory entry.

Rows follow the harness CSV convention ``(name, us_per_call, derived)``:
`derived` is the speedup over ``serial_event`` for the timing rows (the
reference's formula; the share of cold for ``trace_build``), the ratio
for the ``cold_speedup_vs_*`` rows (``cold_speedup_vs_native`` is
``cold_native`` / ``cold``: above 1, the card's study is faster), the
worker count for ``pool_start``, and the raw count for counter rows
(``us_per_call`` = 0).

    PYTHONPATH=src python -m repro_torch.benchmarks.sweep_bench [--quick] [--json [PATH]] [--device cpu] [--min-speedup-pr1 X] [--min-speedup-pr2 X] [--min-speedup-event X]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import os
import shutil
import tempfile
import time
from typing import List, Optional, Tuple

from repro_torch.core.warpsim import _native, machines, runner, sweep
from repro_torch.core.warpsim.divergence import build_thread_trace
from repro_torch.core.warpsim.trace import BENCHMARKS, get_workload

Row = Tuple[str, float, float]

QUICK_BENCHES = ("BFS", "BKP", "MTM", "DYN")
QUICK_N_THREADS = 512
REPS = 2
JSON_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                         "..", "..", "benchmarks", "results", "torch",
                         "sweep_bench.json")


def effective_floors(quick: bool,
                     min_speedup_pr1: Optional[float] = None,
                     min_speedup_pr2: Optional[float] = None,
                     min_speedup_event: Optional[float] = None) -> dict:
    """The floors on ``cold``: the reference's per-grid defaults, or a
    higher floor where one is given; a lower one raises ``ValueError``."""
    floors = {"cold_vs_pr1": 1.5 if quick else 2.5,
              "cold_vs_pr2": 1.1 if quick else 1.2,
              "cold_vs_serial_event": 3.0 if quick else 8.0}
    for name, given in (("cold_vs_pr1", min_speedup_pr1),
                        ("cold_vs_pr2", min_speedup_pr2),
                        ("cold_vs_serial_event", min_speedup_event)):
        if given is None:
            continue
        if given < floors[name]:
            raise ValueError(f"{name} floor {given} is below the default "
                             f"{floors[name]}: a floor may only be raised")
        floors[name] = given
    return floors


def pool_start(workers: int) -> Tuple[float, list]:
    """Seconds to start a pool of `workers` (the sweep's start method),
    run :func:`sweep.pool_probe` once in each, and shut it down; and the
    probes' ``(pid, torch imported)``."""
    t0 = time.perf_counter()
    with concurrent.futures.ProcessPoolExecutor(
            workers, mp_context=sweep.pool_context()) as ex:
        probes = list(ex.map(sweep.pool_probe, range(workers)))
    return time.perf_counter() - t0, probes


def _records(results) -> dict:
    return {(m, b): dataclasses.asdict(r)
            for m, per in results.items() for b, r in per.items()}


def _fresh_lrus() -> None:
    sweep.EXPANSION_CACHE.clear()
    sweep.TRACE_CACHE.clear()


def run(quick: bool = False, device="cuda",
        min_speedup_pr1: Optional[float] = None,
        min_speedup_pr2: Optional[float] = None,
        min_speedup_event: Optional[float] = None) -> List[Row]:
    # torch, imported here and not with the module: multiprocessing runs
    # the main script again in each worker, and run as one this module
    # keeps the workers free of torch.
    from repro_torch.core.warpsim import _cuda
    from repro_torch.models.model import resolve_device
    device = resolve_device(device)
    on_card = device.type == "cuda"
    floors = effective_floors(quick, min_speedup_pr1, min_speedup_pr2,
                              min_speedup_event)
    suite = machines.paper_suite()
    benches = QUICK_BENCHES if quick else BENCHMARKS
    n_threads = QUICK_N_THREADS if quick else None
    kw = dict(benches=tuple(benches), n_threads=n_threads, device=device)
    spec = sweep.SweepSpec(machines=suite, benches=tuple(benches),
                           n_threads=n_threads)
    n_families = len(benches) * len(spec.seeds)

    # The C cores are built outside the timed regions (a once-per-machine
    # cost), and so is the pool's server.
    native = _native.available()
    workers = os.cpu_count() or 1
    t_pool = float("inf")
    for _ in range(REPS + 1):
        secs, probes = pool_start(workers)
        t_pool = min(t_pool, secs)
    torch_workers = sum(has_torch for _pid, has_torch in probes)

    host_launches = 0

    def host_phase(fn):
        """Time `fn` (a host-engine phase); count its K2 launches."""
        nonlocal host_launches
        _fresh_lrus()
        n0 = _cuda.launch_count("ws_family_kernel")
        t0 = time.perf_counter()
        out = fn()
        secs = time.perf_counter() - t0
        host_launches += _cuda.launch_count("ws_family_kernel") - n0
        return out, secs

    def with_cache(prefix, fn):
        root = tempfile.mkdtemp(prefix=f"warpsim-sweep-bench-{prefix}-")
        try:
            return fn(sweep.ResultCache(root))
        finally:
            shutil.rmtree(root, ignore_errors=True)

    # The two first baselines: one single-phase expansion a cell, no LRU.
    baseline = dict(group_expansion=False, reuse_expansion=False, **kw)
    t_serial = t_pr1 = float("inf")
    for _ in range(REPS):
        serial, secs = host_phase(lambda: runner.run_suite(
            suite, engine="event", parallel=False, **baseline))
        t_serial = min(t_serial, secs)
    for _ in range(REPS):
        pr1, secs = with_cache("pr1", lambda c: host_phase(
            lambda: runner.run_suite(suite, cache=c, engine="fast_nested",
                                     **baseline)))
        t_pr1 = min(t_pr1, secs)

    t_trace = float("inf")
    for _ in range(REPS):
        t0 = time.perf_counter()
        for b in benches:
            build_thread_trace(get_workload(b, n_threads=n_threads))
        t_trace = min(t_trace, time.perf_counter() - t0)

    # cold_pr2, cold and cold_native interleaved: each repetition times the
    # three back to back, the min taken per phase.
    t_pr2 = t_cold = t_native = float("inf")
    cache_dir = None
    try:
        for _ in range(REPS + 1):
            pr2, secs = with_cache("pr2", lambda c: host_phase(
                lambda: runner.run_suite(suite, cache=c, engine="native",
                                         share_traces=False, **kw)))
            t_pr2 = min(t_pr2, secs)

            if cache_dir is not None:
                shutil.rmtree(cache_dir, ignore_errors=True)
            cache_dir = tempfile.mkdtemp(prefix="warpsim-sweep-bench-")
            _fresh_lrus()
            n0 = _cuda.launch_count("ws_family_kernel")
            t0 = time.perf_counter()
            cold, cold_stats = sweep.run_sweep_with_stats(
                spec, cache=sweep.ResultCache(cache_dir), device=device)
            t_cold = min(t_cold, time.perf_counter() - t0)
            cold_launches = _cuda.launch_count("ws_family_kernel") - n0

            (cold_native, _), secs = with_cache("native", lambda c: host_phase(
                lambda: sweep.run_sweep_with_stats(
                    spec, cache=c, engine="native", device=device)))
            t_native = min(t_native, secs)

        warm_cache = sweep.ResultCache(cache_dir)
        n0 = _cuda.launch_count("ws_family_kernel")
        t0 = time.perf_counter()
        warm, warm_stats = sweep.run_sweep_with_stats(spec, cache=warm_cache,
                                                      device=device)
        t_warm = time.perf_counter() - t0
        warm_launches = _cuda.launch_count("ws_family_kernel") - n0
    finally:
        if cache_dir is not None:
            shutil.rmtree(cache_dir, ignore_errors=True)

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
    if host_launches:
        raise AssertionError(f"the host phases launched ws_family_kernel "
                             f"{host_launches} times")
    want = _records(cold)
    if on_card and _records(sweep.run_sweep(spec, device="cpu",
                                            engine="torch")) != want:
        raise AssertionError("cold records differ from the grid through "
                             "engine='torch'")
    for name, got in (("serial_event", serial), ("cold_pr1", pr1),
                      ("cold_pr2", pr2), ("warm", warm),
                      ("cold_native", cold_native)):
        if _records(got) != want:
            raise AssertionError(f"{name} records differ from cold's")
    n_cells = len(want)
    if warm_cache.hits != n_cells or warm_stats["cache_hits"] != n_cells \
            or cold_stats["cache_misses"] != n_cells \
            or cold_stats["trace_families"] != len(benches):
        raise AssertionError(f"cache counters: cold {cold_stats}, warm "
                             f"{warm_stats}")

    speedup_pr1 = t_pr1 / max(t_cold, 1e-9)
    speedup_pr2 = t_pr2 / max(t_cold, 1e-9)
    speedup_event = t_serial / max(t_cold, 1e-9)
    if on_card:
        for got, floor, base, t_base in (
                (speedup_pr1, floors["cold_vs_pr1"], "cold_pr1", t_pr1),
                (speedup_pr2, floors["cold_vs_pr2"], "cold_pr2", t_pr2),
                (speedup_event, floors["cold_vs_serial_event"],
                 "serial_event", t_serial)):
            if got < floor:
                raise AssertionError(
                    f"cold sweep only {got:.2f}x faster than {base} (floor "
                    f"{floor}x): {t_cold:.6f} s vs {t_base:.6f} s")

    return [
        ("sweep/serial_event", t_serial * 1e6, 1.0),
        ("sweep/cold_pr1", t_pr1 * 1e6, t_serial / max(t_pr1, 1e-9)),
        ("sweep/cold_pr2", t_pr2 * 1e6, t_serial / max(t_pr2, 1e-9)),
        ("sweep/trace_build", t_trace * 1e6, t_trace / max(t_cold, 1e-9)),
        ("sweep/cold", t_cold * 1e6, speedup_event),
        ("sweep/warm", t_warm * 1e6, t_serial / max(t_warm, 1e-9)),
        ("sweep/cold_native", t_native * 1e6,
         t_serial / max(t_native, 1e-9)),
        ("sweep/pool_start", t_pool * 1e6, float(workers)),
        ("sweep/pool_torch_workers", 0.0, float(torch_workers)),
        ("sweep/cold_speedup_vs_pr1", 0.0, speedup_pr1),
        ("sweep/cold_speedup_vs_pr2", 0.0, speedup_pr2),
        ("sweep/cold_speedup_vs_native", 0.0, t_native / max(t_cold, 1e-9)),
        ("sweep/native_engine", 0.0, 1.0 if native else 0.0),
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
    ap.add_argument("--min-speedup-pr1", type=float, default=None,
                    help="raise the floor for cold vs the cold_pr1 baseline")
    ap.add_argument("--min-speedup-pr2", type=float, default=None,
                    help="raise the floor for cold vs the cold_pr2 baseline")
    ap.add_argument("--min-speedup-event", type=float, default=None,
                    help="raise the floor for cold vs serial_event")
    ap.add_argument("--json", nargs="?", const=JSON_PATH, default=None,
                    metavar="PATH",
                    help="also dump the rows as JSON (default path "
                         "benchmarks/results/torch/sweep_bench.json)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions; the "
                         "floors are then reported, not asserted)")
    args = ap.parse_args(argv)

    rows = run(quick=args.quick, device=args.device,
               min_speedup_pr1=args.min_speedup_pr1,
               min_speedup_pr2=args.min_speedup_pr2,
               min_speedup_event=args.min_speedup_event)
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
