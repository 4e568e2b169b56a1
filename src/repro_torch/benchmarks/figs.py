"""The paper's figures on the port: one method per figure.

    PYTHONPATH=src python -m repro_torch.benchmarks.figs [--device cpu]
        [--only fig1,fig7] [--cache-dir DIR]

Each ``figN_*`` returns CSV rows ``(name, us_per_call, derived)``:
`us_per_call` is the host-clock time of the grid that made the row, per
cell, and `derived` the figure's metric (normalized performance,
coalescing rate, idle share, IPC). Each figure's data is also written as
JSON under ``benchmarks/results/torch/`` (gitignored).

Every grid runs through one :class:`~repro_torch.core.warpsim.api.Session`
built by ``Session.from_env``, as the reference's figures do: with
``WARPSIM_SERVICE_URL`` (or ``WARPSIM_SERVICE_URLS``) naming a live
daemon the grids are served by it (and a second run re-simulates
nothing there); else they run in this process over an on-disk cell cache
(``benchmarks/results/torch/sweep_cache`` by default), so a second run
simulates nothing. In-process grids run on the card (the family kernels)
unless ``--device cpu`` asks for the plain versions.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Tuple

import numpy as np

from repro_torch.core.warpsim import api, machines, runner

RESULTS_DIR = str(Path(__file__).resolve().parents[3] / "benchmarks"
                  / "results" / "torch")
SWEEP_CACHE_DIR = os.path.join(RESULTS_DIR, "sweep_cache")
Row = Tuple[str, float, float]

# Workload seeds of the variance bands of Figs. 4/7.
BAND_SEEDS = (0, 1, 2)
PAPER_MACHINES = ("ws8", "ws16", "ws32", "ws64", "SW+", "LW+")
WARP_MACHINES = PAPER_MACHINES[:4]


class Figures:
    """The figures over one session; each grid runs once per instance."""

    def __init__(self, session: api.Session, results_dir: str = RESULTS_DIR):
        self.session = session
        self.results_dir = results_dir
        self._simd: Dict[int, Tuple[api.StudyResult, float]] = {}

    def _save(self, name: str, obj) -> None:
        os.makedirs(self.results_dir, exist_ok=True)
        with open(os.path.join(self.results_dir, name), "w") as f:
            json.dump(obj, f, indent=1)

    def _run(self, machine_set, seeds=(0,)) -> Tuple[api.StudyResult, float]:
        t0 = time.perf_counter()
        res = self.session.run(api.Study(machines=machine_set,
                                         seeds=tuple(seeds)))
        return res, (time.perf_counter() - t0) * 1e6

    @functools.cached_property
    def suite(self) -> Tuple[api.StudyResult, float]:
        return self._run(machines.paper_suite())

    @functools.cached_property
    def suite_seeds(self) -> Tuple[api.StudyResult, float]:
        return self._run(machines.paper_suite(), BAND_SEEDS)

    def simd_sweep(self, simd_width: int) -> Tuple[api.StudyResult, float]:
        if simd_width not in self._simd:
            self._simd[simd_width] = self._run(
                machines.warp_size_sweep(simd_width))
        return self._simd[simd_width]

    def fig1_warpsize_simd(self) -> List[Row]:
        """Fig. 1: perf vs warp size for SIMD widths 8/16/32, normalized to
        8-wide SIMD with 4x warp size (= warp 32)."""
        rows, dump = [], {}
        base_res, _ = self.simd_sweep(8)
        base = runner.mean_ipc(base_res.per_bench("simd8_ws32"))
        for simd in (8, 16, 32):
            res, us = self.simd_sweep(simd)
            for name in res.machines:
                norm = runner.mean_ipc(res.per_bench(name)) / base
                rows.append((f"fig1/{name}", us / len(res.machines), norm))
                dump[name] = norm
        self._save("fig1_warpsize_simd.json", dump)
        return rows

    def _per_bench_metric(self, metric: str, mnames
                          ) -> Tuple[List[Row], Dict[str, float]]:
        res, us = self.suite
        rows, dump = [], {}
        per_cell_us = us / (len(res.machines) * len(res.benches))
        for m in mnames:
            for b, r in res.per_bench(m).items():
                val = getattr(r, metric)
                rows.append((f"{m}/{b}", per_cell_us, val))
                dump[f"{m}/{b}"] = val
        return rows, dump

    def fig2_coalescing(self) -> List[Row]:
        """Fig. 2: coalescing rate (offchip requests / mem insn) per warp
        size, normalized to ws32."""
        res, us = self.suite
        rows, dump = [], {}
        ws32 = res.per_bench("ws32")
        for m in WARP_MACHINES:
            for b, r in res.per_bench(m).items():
                norm = r.coalescing_rate / max(ws32[b].coalescing_rate, 1e-12)
                rows.append((f"fig2/{m}/{b}", us / 60, norm))
                dump[f"{m}/{b}"] = norm
        self._save("fig2_coalescing.json", dump)
        return rows

    def _figure(self, fig: str, metric: str, mnames, out: str) -> List[Row]:
        rows, dump = self._per_bench_metric(metric, mnames)
        self._save(out, dump)
        return [(f"{fig}/{n}", u, v) for n, u, v in rows]

    def fig3_idle(self) -> List[Row]:
        """Fig. 3: idle-cycle share per warp size."""
        return self._figure("fig3", "idle_share", WARP_MACHINES,
                            "fig3_idle.json")

    def fig4_perf(self) -> List[Row]:
        """Fig. 4: IPC per warp size, plus workload-seed variance bands
        (mean and min/max of suite-geomean IPC over seeds)."""
        rows, dump = self._per_bench_metric("ipc", WARP_MACHINES)
        rows = [(f"fig4/{n}", u, v) for n, u, v in rows]
        seeded, us = self.suite_seeds
        for m in WARP_MACHINES:
            vals = [runner.mean_ipc(seeded.per_bench(m, seed=s))
                    for s in BAND_SEEDS]
            band = {"mean": float(np.mean(vals)),
                    "min": float(min(vals)), "max": float(max(vals))}
            for stat, v in band.items():
                rows.append((f"fig4/band/{m}/{stat}", us / len(BAND_SEEDS),
                             v))
            dump[f"band/{m}"] = band
        self._save("fig4_perf.json", dump)
        return rows

    def fig5_swlw_coalescing(self) -> List[Row]:
        """Fig. 5: coalescing rate incl. SW+ and LW+."""
        return self._figure("fig5", "coalescing_rate", PAPER_MACHINES,
                            "fig5_swlw_coalescing.json")

    def fig6_swlw_idle(self) -> List[Row]:
        """Fig. 6: idle share incl. SW+ and LW+."""
        return self._figure("fig6", "idle_share", PAPER_MACHINES,
                            "fig6_swlw_idle.json")

    def fig7_swlw_perf(self) -> List[Row]:
        """Fig. 7: IPC incl. SW+ and LW+, the headline averages and their
        multi-seed bands."""
        rows, dump = self._per_bench_metric("ipc", PAPER_MACHINES)
        rows = [(f"fig7/{n}", u, v) for n, u, v in rows]
        res, us = self.suite
        summary = res.summary()
        for k, v in summary.items():
            rows.append((f"fig7/summary/{k}", us, v))
        dump["summary"] = summary
        seeded, us_b = self.suite_seeds
        bands = seeded.bands()
        for k, band in bands.items():
            for stat in ("mean", "min", "max"):
                rows.append((f"fig7/band/{k}/{stat}", us_b, band[stat]))
        dump["summary_bands"] = bands
        self._save("fig7_swlw_perf.json", dump)
        return rows

    def figures(self) -> Dict[str, Callable[[], List[Row]]]:
        return {"fig1": self.fig1_warpsize_simd,
                "fig2": self.fig2_coalescing, "fig3": self.fig3_idle,
                "fig4": self.fig4_perf, "fig5": self.fig5_swlw_coalescing,
                "fig6": self.fig6_swlw_idle, "fig7": self.fig7_swlw_perf}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.benchmarks.figs",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels, default) or cpu")
    ap.add_argument("--only", default=None,
                    help="comma-separated figure names (default: all)")
    ap.add_argument("--cache-dir", default=SWEEP_CACHE_DIR,
                    help="on-disk cell cache of an in-process session")
    args = ap.parse_args(argv)
    figs = Figures(api.Session.from_env(cache_dir=args.cache_dir,
                                        device=args.device))
    only = args.only.split(",") if args.only else None
    print("name,us_per_call,derived")
    for name, fn in figs.figures().items():
        if only and name not in only:
            continue
        for row_name, us, val in fn():
            print(f"{row_name},{us:.3f},{val:.6f}")
    sys.stdout.flush()


if __name__ == "__main__":
    main()
