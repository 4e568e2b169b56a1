"""The paper's aggregation helpers: suite means and the headline table."""

from __future__ import annotations

from typing import Iterable, Mapping

import numpy as np

from repro_torch.core.warpsim.timing import SimResult


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
