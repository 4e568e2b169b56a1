"""Benchmark x machine suite driver (over the ``api`` session) and the
paper's aggregation helpers: suite means and the headline table."""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, Mapping, Optional

import numpy as np

from repro_torch.core.warpsim import api
from repro_torch.core.warpsim import sweep as sweep_mod
from repro_torch.core.warpsim.config import MachineConfig
from repro_torch.core.warpsim.divergence import expand_stream
from repro_torch.core.warpsim.timing import SimResult, simulate
from repro_torch.core.warpsim.trace import BENCHMARKS, get_workload


def run_one(bench: str, cfg: MachineConfig, n_threads: Optional[int] = None,
            seed: int = 0, engine: str = "auto", device="cuda") -> SimResult:
    """One cell, expanded from scratch: a one-unit family launch."""
    wl = get_workload(bench, n_threads=n_threads, seed=seed)
    stream = expand_stream(wl, cfg)
    return simulate(wl.name, stream, cfg, engine=engine, device=device)


def run_suite(
    machine_set: Optional[Mapping[str, MachineConfig]] = None,
    benches: Iterable[str] = BENCHMARKS,
    n_threads: Optional[int] = None,
    seed: int = 0,
    cache: Optional[sweep_mod.ResultCache] = None,
    parallel: Optional[bool] = None,
    engine: str = "auto",
    seeds: Optional[Iterable[int]] = None,
    group_expansion: bool = True,
    reuse_expansion: bool = True,
    share_traces: bool = True,
    service_url: Optional[str] = None,
    device="cuda",
) -> Dict:
    """``results[machine][bench] -> SimResult`` (``results[seed][machine]
    [bench]`` with more than one seed), through a fresh
    :class:`~repro_torch.core.warpsim.api.Session` on `device`. The
    nested-dict shape of the reference's ``run_suite``; new code should
    hold the typed ``StudyResult``.

    In process (an :class:`~repro_torch.core.warpsim.api.InProcessBackend`
    over `cache`), `parallel` forces or forbids the host engines' process
    pool (default: the sweep's rule), and `group_expansion`,
    `reuse_expansion` and `share_traces` pick the sweep's modes. With
    `service_url` the study runs on that daemon (an
    :class:`~repro_torch.core.warpsim.api.ServiceBackend`): the daemon
    owns the cache and the device, the local flags are ignored, and a dead
    URL raises.
    """
    study = api.Study(
        benches=tuple(benches), machines=machine_set, n_threads=n_threads,
        seeds=tuple(seeds) if seeds is not None else (seed,), engine=engine)
    if service_url:
        backend: api.Backend = api.ServiceBackend(service_url)
    else:
        backend = api.InProcessBackend(
            parallel=parallel, group_expansion=group_expansion,
            reuse_expansion=reuse_expansion, share_traces=share_traces,
            result_cache=cache)
    session = api.Session(device=device)
    return session.run(study, backend=backend).legacy_grid()


def geomean(xs: Iterable[float]) -> float:
    xs = np.asarray(list(xs), dtype=np.float64)
    return float(np.exp(np.mean(np.log(np.maximum(xs, 1e-12)))))


def mean_ipc(results: Mapping[str, SimResult]) -> float:
    return geomean(r.ipc for r in results.values())


def mean_speedup(a: Mapping[str, SimResult], b: Mapping[str, SimResult]) -> float:
    """Geomean over benchmarks of IPC(a)/IPC(b)."""
    return geomean(a[k].ipc / b[k].ipc for k in a)


def mean_coalescing_improvement(a: Mapping[str, SimResult],
                                b: Mapping[str, SimResult]) -> float:
    """Reduction of suite-mean requests-per-mem-insn of `a` vs `b`.

    Paper Fig. 5 reports SW+ 'improves coalescing rate by 21%/30%' vs
    32/64-thread warps — i.e. relative reduction of eq.(1).
    """
    ra = float(np.mean([r.coalescing_rate for r in a.values()]))
    rb = float(np.mean([r.coalescing_rate for r in b.values()]))
    return 1.0 - ra / max(rb, 1e-12)


def mean_idle_reduction(a: Mapping[str, SimResult],
                        b: Mapping[str, SimResult]) -> float:
    """Reduction of the suite-mean idle-cycle share of `a` vs `b`."""
    ia = float(np.mean([r.idle_share for r in a.values()]))
    ib = float(np.mean([r.idle_share for r in b.values()]))
    return 1.0 - ia / max(ib, 1e-12)


def suite_summary(results: Mapping) -> dict:
    """Headline numbers in the shape of the paper's claims.

    Accepts either a single-seed grid ``results[machine][bench]`` (returns
    ``{metric: float}``) or the seed-keyed ``results[seed][machine][bench]``
    shape — then every metric is averaged over seeds and returned as
    ``{metric: {"mean", "min", "max"}}`` variance bands.
    """
    if results and all(isinstance(k, (int, np.integer)) for k in results):
        per_seed = [suite_summary(r) for r in results.values()]
        bands = {}
        for k in per_seed[0]:
            vals = [s[k] for s in per_seed]
            bands[k] = {"mean": float(np.mean(vals)),
                        "min": min(vals), "max": max(vals)}
        return bands
    s = {}
    if "SW+" in results and "LW+" in results:
        s["swplus_over_lwplus"] = mean_speedup(results["SW+"], results["LW+"])
    for w in (8, 16, 32, 64):
        k = f"ws{w}"
        if k in results:
            if "SW+" in results:
                s[f"swplus_over_{k}"] = mean_speedup(results["SW+"], results[k])
            if "LW+" in results:
                s[f"lwplus_over_{k}"] = mean_speedup(results["LW+"], results[k])
    if "SW+" in results:
        for w in (8, 16, 32):
            k = f"ws{w}"
            if k in results:
                s[f"swplus_idle_reduction_vs_{k}"] = mean_idle_reduction(
                    results["SW+"], results[k])
        for w in (32, 64):
            k = f"ws{w}"
            if k in results:
                s[f"swplus_coalescing_improvement_vs_{k}"] = (
                    mean_coalescing_improvement(results["SW+"], results[k]))
    return s


def save_results(results: Mapping[str, Mapping[str, SimResult]],
                 path: str) -> None:
    """Write a one-seed grid as JSON (``SimResult.as_dict`` per cell)."""
    blob = {m: {b: r.as_dict() for b, r in rb.items()}
            for m, rb in results.items()}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(blob, f, indent=1)
    os.replace(tmp, path)
