"""Run one cell of the benchmark once and print its result line.

    python3 -m warpbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Set-up imports the program
(``repro_torch``, from the checkout's ``src``), builds a
:class:`~repro_torch.core.warpsim.api.Session` with an on-disk
ResultCache under ``TMPDIR`` and trace and expansion LRUs sized to the
cell's working set, and runs the traffic's warm-up grids. The window
then runs the traffic's steps back to back for ``--seconds``; the step in
flight when the time is up runs to its end and counts, with its time.
Once the window has closed, a sample of its cells is checked against the
plain reference (:mod:`warpbench.check`). With ``--trace 1`` the window
runs under torch.profiler and the host-stage timers, and the line holds
the per-layer metrics instead of the end-to-end ones.

The last line of standard output is the result's JSON object; the
compared numbers, each beside its limit, are the last lines of standard
error.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Tuple

from warpbench import check, devtrace, spec, stages
from warpbench.traffic import Step, Traffic

#: Top-level module names no run may hold once its window has closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def forbidden_modules(names=None) -> List[str]:
    """The forbidden top-level names among `names` (``sys.modules`` when
    omitted), each compared whole: ``repro_torch`` is not ``repro``."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def grids(config: Dict, point: Dict) -> List[Tuple[Dict, Tuple, int]]:
    """The studies of one grid at machine `point`: ``(machines, benches,
    n_threads)`` for each machine set and thread count, where `machines`
    maps each machine's name to all its fields."""
    threads = config["threads"]
    out = []
    for mset in config["machine_sets"]:
        machines = {name: {"name": name, **config["machine"], **fields,
                           **point}
                    for name, fields in mset.items()}
        for nt in sorted(set(threads.values()), reverse=True):
            out.append((machines, tuple(b for b in threads
                                        if threads[b] == nt), nt))
    return out


def working_set(config: Dict) -> Tuple[int, int]:
    """Traces and streams one grid at one workload seed holds."""
    keys = sum(len({(m["warp_size"], m["simd_width"], m["mimd"])
                    for m in mset.values()})
               for mset in config["machine_sets"])
    return len(config["threads"]), keys * len(config["threads"])


@dataclasses.dataclass
class Run:
    """What one run measured: the readers of the metrics take it."""

    setup_s: float = 0.0
    window_s: float = 0.0
    cells: int = 0
    steps: int = 0
    stages: Optional[Dict[str, float]] = None      # host seconds by stage
    launches: Optional[List[Tuple[int, int]]] = None   # K2 work a launch
    device: Optional[Dict] = None                  # devtrace.summarize
    counters: Dict[str, int] = dataclasses.field(default_factory=dict)


class Harness:
    """The program, set up for one cell on one device."""

    def __init__(self, config: Dict, device: str, root: str):
        from repro_torch.core.warpsim import _cuda, api, sweep
        from repro_torch.core.warpsim.config import MachineConfig
        self.api, self.sweep, self.cuda = api, sweep, _cuda
        self.MachineConfig = MachineConfig
        self.config = config
        self.device = device
        self.engine = "cuda" if device.startswith("cuda") else "torch"
        self.cache_root = os.path.join(root, "results")
        n_traces, n_streams = working_set(config)
        self.session = api.Session(
            device=device, result_cache=sweep.ResultCache(self.cache_root),
            trace_cache=sweep.TraceCache(maxsize=n_traces),
            expansion_cache=sweep.ExpansionCache(maxsize=n_streams))
        self.stats: Dict[str, int] = {}

    def run_step(self, step: Step, done: Optional[List] = None) -> int:
        """Run every grid of `step`; returns the cells simulated. Appends
        ``(record, machine fields, MachineConfig)`` of each to `done`."""
        cells = 0
        for point in step.points:
            for machines, benches, nt in grids(self.config, point):
                cfgs = {n: self.MachineConfig(**f)
                        for n, f in machines.items()}
                study = self.api.Study(
                    benches=benches, machines=cfgs, n_threads=nt,
                    seeds=(step.seed,), engine=self.engine)
                res = self.session.run(study)
                want = len(benches) * len(cfgs)
                if len(res.records) != want:
                    raise RuntimeError(f"a study of {want} cells returned "
                                       f"{len(res.records)} records")
                for k, v in res.stats.items():
                    if isinstance(v, int):
                        self.stats[k] = self.stats.get(k, 0) + v
                if done is not None:
                    done.extend((r, machines[r.machine], cfgs[r.machine])
                                for r in res.records)
                cells += want
        return cells

    def lru_bytes(self) -> int:
        """Host bytes of the arrays the trace and expansion LRUs hold."""
        total = 0
        for cache, attr in ((self.session.trace_cache, "_traces"),
                            (self.session.expansion_cache, "_streams")):
            for _wl, obj in getattr(cache, attr, {}).values():
                total += sum(getattr(v, "nbytes", 0)
                             for v in vars(obj).values())
        return total

    def cached(self, rec, cfg) -> Optional[Dict]:
        """The ResultCache's entry for a record's cell, read back anew."""
        key = self.sweep.cell_key(rec.bench, cfg, rec.n_threads, rec.seed)
        hit = self.sweep.ResultCache(self.cache_root).get(key)
        return dataclasses.asdict(hit) if hit is not None else None


def since_process_start() -> Optional[float]:
    """Seconds since this process started (to 1/CLK_TCK), from /proc; None
    where there is none."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None
             ) -> Tuple[Run, Dict, Dict, List[check.Done]]:
    """One run of `cell`: ``(Run, the result line without its metrics, the
    compared numbers, the sampled cells)``. `device` ``"cpu"`` runs the
    plain versions of the family kernels (what the tests drive)."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch
    on_card = device.startswith("cuda")
    marks = [("torch imported and the devices counted", time.perf_counter())]
    if on_card:
        torch.empty(1, device=device)
        torch.cuda.synchronize()
        marks.append(("the card's context made", time.perf_counter()))
    traffic = Traffic(cell.traffic, seed)
    workdir = tempfile.mkdtemp(prefix="warpbench-")
    try:
        h = Harness(cell.config, device, workdir)
        marks.append(("the program imported", time.perf_counter()))
        if on_card:
            h.cuda.load()
            marks.append(("K2's library loaded", time.perf_counter()))
        routes0 = {p: h.cuda.route_count("ws_family_kernel", p)
                   for p in h.cuda.PLACEMENTS}
        h.run_step(traffic.warmup())
        if on_card:
            torch.cuda.synchronize()
        marks.append(("the warm-up run", time.perf_counter()))
        run = Run(setup_s=marks[-1][1] - t_start)
        log(f"setup {run.setup_s:.4f} s: " + ", ".join(
            f"{what} at {t - t_start:.4f}" for what, t in marks)
            + f" ({h.stats})")
        cache0 = h.session.cache_stats()
        stats0 = dict(h.stats)
        done: List = []
        with _instruments(h, trace, on_card, torch, run):
            t0 = time.perf_counter()
            ends = [t0]
            for step in traffic.steps():
                if run.steps and ends[-1] - t0 >= seconds:
                    break
                run.cells += h.run_step(step, done)
                run.steps += 1
                ends.append(time.perf_counter())
            run.window_s = ends[-1] - t0
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        cache1 = h.session.cache_stats()
        window = {k: h.stats.get(k, 0) - stats0.get(k, 0) for k in h.stats}
        routes = {p: h.cuda.route_count("ws_family_kernel", p) - routes0[p]
                  for p in h.cuda.PLACEMENTS}
        run.counters = dict(
            window,
            trace_builds=(cache1["trace_cache"]["builds"]
                          - cache0["trace_cache"]["builds"]),
            aggregations=(cache1["expansion_cache"]["misses"]
                          - cache0["expansion_cache"]["misses"]),
            expansion_hits=(cache1["expansion_cache"]["hits"]
                            - cache0["expansion_cache"]["hits"]),
            result_cache_hits=(cache1["result_cache"]["hits"]
                               - cache0["result_cache"]["hits"]))
        log(f"window {run.window_s:.4f} s: {run.steps} steps, {run.cells} "
            f"cells; study stats {window}")
        log("step walls (s): " + " ".join(
            f"{b - a:.4f}" for a, b in zip(ends, ends[1:])))
        log(f"K2 launches by placement (warm-up and window): {routes}")
        c = run.counters
        log(f"LRUs: trace builds {c['trace_builds']}, aggregations "
            f"{c['aggregations']}, expansion hits {c['expansion_hits']} in "
            f"the window; hold {h.lru_bytes()} host bytes; ResultCache "
            f"{cache1['result_cache']}")
        picked = check.pick(
            [traffic.stratum(fields, r.n_threads) for r, fields, _c in done],
            [r.result.cycles for r, _f, _c in done], seed)
        sample = [check.Done(r.bench, r.n_threads, r.seed, fields,
                             dataclasses.asdict(r.result), h.cached(r, cfg))
                  for r, fields, cfg in (done[i] for i in picked)]
        del h, done
        if on_card:
            torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        numbers, diffs = check.compare(sample)
        log(f"reference: {len(sample)} cells in "
            f"{time.perf_counter() - t_ref:.2f} s")
        for d in diffs:
            log(f"differs: {d}")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell.chips if on_card else 0,
           "memory_peak_bytes": int(peak)}
    if trace and run.device is not None:
        dev["busy_s"] = run.device["busy_s"]
        dev["window_s"] = run.device["window_s"]
    out = {"correct": check.verdict(numbers), "attempted": run.cells,
           "failed": 0, "device": dev}
    return run, out, numbers, sample


@contextlib.contextmanager
def _instruments(h: Harness, trace: bool, on_card: bool, torch, run: Run):
    """The traced window's instruments (none with `trace` off): the
    profiler on the card, K2's work a launch, the host-stage timers."""
    if not trace:
        yield
        return
    with contextlib.ExitStack() as stack:
        annotate = None
        if on_card:
            from torch.profiler import record_function
            annotate = record_function
            run.device = {}
            stack.enter_context(devtrace.profiled(torch, run.device))
        run.launches = stack.enter_context(stages.launch_work(h.cuda))
        run.stages = stack.enter_context(
            stages.stage_timers(h.sweep, h.cuda, annotate))
        yield


def power_limit() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None, t_start: Optional[float] = None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m warpbench",
                                description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    t_start = time.perf_counter() if t_start is None else t_start
    cell = spec.find_cell(args.workload)
    before = since_process_start()
    if before is not None:
        log(f"{before - (time.perf_counter() - t_start):.2f} s from the "
            f"process's start to the harness's first line")
    import torch
    log(f"torch imported at {time.perf_counter() - t_start:.4f} s")
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA device(s); "
            f"{torch.cuda.device_count()} visible")
        return 2
    run, out, numbers, _ = run_cell(cell, args.seed, args.seconds,
                                    bool(args.trace), "cuda", t_start)
    if forbidden_modules():
        log(f"loaded in this process: {forbidden_modules()}; no result")
        return 3
    metrics = cell.per_layer if args.trace else cell.end_to_end
    out["metrics"] = spec.read_metrics(metrics, run)
    if args.trace and run.device is not None:
        out["breakdown"] = devtrace.breakdown(run.device)
        log(f"K2 device records {run.device['k2_records']} for "
            f"{len(run.launches or [])} launches; K2 {run.device['k2_s']} s")
    out["checks"] = check.lines(numbers)
    log(f"card: {power_limit()}")
    for name, c in out["checks"].items():
        log(f"check {name} {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(out), flush=True)
    return 0
