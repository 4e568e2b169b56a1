"""The facade of the warp-size study: Study, StudyResult, Session.

* :class:`Study` — a declarative bench × machine × seed grid plus the
  timing `engine` (``"cuda"``: the family kernels; ``"torch"``: their
  plain versions on the CPU; ``"auto"``: whichever the session's device
  runs).
* :class:`StudyResult` — flat :class:`RunRecord` tuples in the study's
  fixed cell order, the run's stats, and accessors (:meth:`~StudyResult.by`,
  :meth:`~StudyResult.per_bench`, :meth:`~StudyResult.grid`,
  :meth:`~StudyResult.summary`, :meth:`~StudyResult.bands`).
* :class:`Session` — runs studies in this process on one device
  (``"cuda"`` unless the caller asks for ``"cpu"``) and owns the in-memory
  trace and stream dicts that later studies reuse.

Usage::

    from repro_torch.core.warpsim import api
    res = api.Session().run(api.Study(seeds=(0, 1, 2)))
    res.summary()["swplus_over_lwplus"]      # mean/min/max over seeds
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

from repro_torch.core.warpsim import sweep as sweep_mod
from repro_torch.core.warpsim.config import MachineConfig
from repro_torch.core.warpsim.timing import SimResult
from repro_torch.core.warpsim.trace import BENCHMARKS


@dataclasses.dataclass(frozen=True)
class Study:
    """A declarative bench x machine x seed grid plus the timing engine.

    Same defaults and the same machines-major / benches / seeds-innermost
    cell order as :class:`~repro_torch.core.warpsim.sweep.SweepSpec`.
    """

    benches: Tuple[str, ...] = tuple(BENCHMARKS)
    machines: Optional[Mapping[str, MachineConfig]] = None
    simd_width: int = 8
    n_threads: Optional[int] = None
    seeds: Tuple[int, ...] = (0,)
    engine: str = "auto"

    def to_spec(self) -> sweep_mod.SweepSpec:
        return sweep_mod.SweepSpec(
            benches=self.benches, machines=self.machines,
            simd_width=self.simd_width, n_threads=self.n_threads,
            seeds=self.seeds)


@dataclasses.dataclass(frozen=True)
class RunRecord:
    """One executed grid cell: coordinates + its :class:`SimResult`."""

    machine: str
    bench: str
    seed: int
    n_threads: Optional[int]
    result: SimResult


@dataclasses.dataclass(frozen=True)
class StudyResult:
    """Flat, typed study output: records in the study's fixed cell order,
    plus the producing run's stats."""

    records: Tuple[RunRecord, ...]
    stats: Dict[str, float] = dataclasses.field(default_factory=dict)
    backend: str = "inprocess"

    @property
    def seeds(self) -> Tuple[int, ...]:
        return tuple(dict.fromkeys(r.seed for r in self.records))

    def __len__(self) -> int:
        return len(self.records)

    def by(self, machine: Optional[str] = None, bench: Optional[str] = None,
           seed: Optional[int] = None) -> "StudyResult":
        """Filtered view (record order preserved); chainable."""
        recs = tuple(
            r for r in self.records
            if (machine is None or r.machine == machine)
            and (bench is None or r.bench == bench)
            and (seed is None or r.seed == seed))
        return StudyResult(records=recs, stats=self.stats,
                           backend=self.backend)

    def per_bench(self, machine: str,
                  seed: Optional[int] = None) -> Dict[str, SimResult]:
        """``{bench: SimResult}`` for one machine (and seed, when
        multi-seed) — the shape ``runner.mean_speedup`` consumes."""
        if seed is None:
            seeds = self.seeds
            if len(seeds) > 1:
                raise ValueError(f"multi-seed result ({seeds}): pass seed=")
            seed = seeds[0]
        out = {r.bench: r.result for r in self.records
               if r.machine == machine and r.seed == seed}
        if not out:
            raise KeyError(f"no records for machine {machine!r} "
                           f"seed {seed}")
        return out

    def grid(self) -> Dict[int, Dict[str, Dict[str, SimResult]]]:
        """Seed-keyed nested dict ``results[seed][machine][bench]``."""
        out: Dict[int, Dict[str, Dict[str, SimResult]]] = {
            s: {} for s in self.seeds}
        for r in self.records:
            out[r.seed].setdefault(r.machine, {})[r.bench] = r.result
        return out

    def summary(self) -> dict:
        """Paper-headline numbers (``runner.suite_summary``): plain floats
        for a single seed, mean/min/max bands over several."""
        from repro_torch.core.warpsim import runner
        g = self.grid()
        return runner.suite_summary(next(iter(g.values())) if len(g) == 1
                                    else g)

    def bands(self) -> dict:
        """Per-metric ``{"mean", "min", "max"}`` bands over seeds
        (degenerate for a single-seed study)."""
        from repro_torch.core.warpsim import runner
        return runner.suite_summary(self.grid())


def records_from_grid(spec: sweep_mod.SweepSpec,
                      results: Mapping) -> Tuple[RunRecord, ...]:
    """Flatten ``results[seed][machine][bench]`` into spec-ordered records."""
    return tuple(
        RunRecord(machine=mname, bench=bench, seed=seed, n_threads=n_threads,
                  result=results[seed][mname][bench])
        for mname, _cfg, bench, n_threads, seed in spec.cells())


class Session:
    """Runs studies in this process on one `device`.

    The trace and stream dicts are instance state: studies run through one
    session share ThreadTraces and aggregated WarpStreams; two sessions
    share nothing.
    """

    def __init__(self, device="cuda"):
        self.device = device
        self.traces: dict = {}
        self.streams: dict = {}

    def run(self, study: Study) -> StudyResult:
        spec = study.to_spec()
        results, stats = sweep_mod.run_sweep_with_stats(
            spec, device=self.device, engine=study.engine,
            traces=self.traces, streams=self.streams)
        return StudyResult(records=records_from_grid(spec, results),
                           stats=stats)
