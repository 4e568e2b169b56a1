"""The facade of the warp-size study: Study, StudyResult, Session.

* :class:`Study` — a declarative bench × machine × seed grid (or a dense
  warp-size range) plus the timing `engine` (``"cuda"``: the family
  kernels; ``"torch"``: their plain versions on the CPU; ``"auto"``:
  whichever the session's device runs). JSON-safe via
  :meth:`Study.to_dict` / :meth:`Study.from_dict`, in the reference's
  encoding.
* :class:`StudyResult` — flat :class:`RunRecord` tuples in the study's
  fixed cell order, the run's stats, and accessors (:meth:`~StudyResult.by`,
  :meth:`~StudyResult.one`, :meth:`~StudyResult.per_bench`,
  :meth:`~StudyResult.grid`, :meth:`~StudyResult.summary`,
  :meth:`~StudyResult.bands`, :meth:`~StudyResult.to_json`).
* :class:`Session` — runs studies in this process on one device
  (``"cuda"`` unless the caller asks for ``"cpu"``) and owns the cache
  stack: an optional on-disk :class:`~repro_torch.core.warpsim.sweep.
  ResultCache` (`cache_dir`), shared with the reference package (same
  keys, same files), and the session's own trace and expansion LRUs.

Usage::

    from repro_torch.core.warpsim import api
    session = api.Session(cache_dir="benchmarks/results/torch/sweep_cache")
    res = session.run(api.Study(seeds=(0, 1, 2)))
    res.summary()["swplus_over_lwplus"]      # mean/min/max over seeds
    session.cell("BFS", "SW+").ipc           # one cell, cached
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterator, Mapping, Optional, Tuple

from repro_torch.core.warpsim import machines as machines_mod
from repro_torch.core.warpsim import sweep as sweep_mod
from repro_torch.core.warpsim.config import MachineConfig
from repro_torch.core.warpsim.timing import SimResult
from repro_torch.core.warpsim.trace import BENCHMARKS


def resolve_machine_name(name: str, simd_width: int = 8) -> MachineConfig:
    """Preset config for a suite name (``SW+``, ``LW+``) or ``ws<N>``."""
    suite = machines_mod.paper_suite(simd_width)
    if name in suite:
        return suite[name]
    if name.startswith("ws") and name[2:].isdigit():
        return machines_mod.baseline(int(name[2:]), simd_width)
    raise ValueError(f"unknown machine {name!r} (suite names: "
                     f"{', '.join(suite)}, or ws<N>)")


@dataclasses.dataclass(frozen=True)
class Study:
    """A declarative bench x machine x seed grid plus the timing engine.

    Field-for-field the :class:`~repro_torch.core.warpsim.sweep.SweepSpec`
    (same defaults, same machines-major / benches / seeds-innermost cell
    order) with `engine` added.
    """

    benches: Tuple[str, ...] = tuple(BENCHMARKS)
    machines: Optional[Mapping[str, MachineConfig]] = None
    warp_sizes: Tuple[int, ...] = ()
    simd_width: int = 8
    n_threads: Optional[int] = None
    seeds: Tuple[int, ...] = (0,)
    engine: str = "auto"

    @classmethod
    def from_spec(cls, spec: sweep_mod.SweepSpec,
                  engine: str = "auto") -> "Study":
        return cls(benches=spec.benches, machines=spec.machines,
                   warp_sizes=spec.warp_sizes, simd_width=spec.simd_width,
                   n_threads=spec.n_threads, seeds=spec.seeds,
                   engine=engine or "auto")

    @classmethod
    def warp_size_range(cls, lo: int = 4, hi: int = 128,
                        simd_width: int = 8, engine: str = "auto",
                        **kw) -> "Study":
        """Dense power-of-two warp-size scaling study, `lo`..`hi`."""
        return cls.from_spec(
            sweep_mod.SweepSpec.warp_size_range(lo, hi,
                                                simd_width=simd_width, **kw),
            engine=engine)

    def to_spec(self) -> sweep_mod.SweepSpec:
        return sweep_mod.SweepSpec(
            benches=self.benches, machines=self.machines,
            warp_sizes=self.warp_sizes, simd_width=self.simd_width,
            n_threads=self.n_threads, seeds=self.seeds)

    def machine_set(self) -> Dict[str, MachineConfig]:
        return self.to_spec().machine_set()

    def cells(self, machine_set=None):
        return self.to_spec().cells(machine_set=machine_set)

    def to_dict(self) -> dict:
        """JSON-safe encoding (the reference's ``POST /study`` body)."""
        d = sweep_mod.spec_to_dict(self.to_spec())
        d["engine"] = self.engine
        return d

    @classmethod
    def from_dict(cls, d: Mapping) -> "Study":
        return cls.from_spec(sweep_mod.spec_from_dict(d),
                             engine=d.get("engine") or "auto")


@dataclasses.dataclass(frozen=True)
class RunRecord:
    """One executed grid cell: coordinates + its :class:`SimResult`."""

    machine: str
    bench: str
    seed: int
    n_threads: Optional[int]
    result: SimResult

    def to_wire(self) -> dict:
        return {"machine": self.machine, "bench": self.bench,
                "seed": self.seed, "n_threads": self.n_threads,
                "result": dataclasses.asdict(self.result)}

    @classmethod
    def from_wire(cls, d: Mapping) -> "RunRecord":
        return cls(machine=d["machine"], bench=d["bench"],
                   seed=int(d["seed"]), n_threads=d.get("n_threads"),
                   result=SimResult(**d["result"]))


@dataclasses.dataclass(frozen=True)
class StudyResult:
    """Flat, typed study output: records in the study's fixed cell order,
    plus the producing run's stats."""

    records: Tuple[RunRecord, ...]
    stats: Dict[str, float] = dataclasses.field(default_factory=dict)
    backend: str = "inprocess"

    @property
    def machines(self) -> Tuple[str, ...]:
        return self._uniq("machine")

    @property
    def benches(self) -> Tuple[str, ...]:
        return self._uniq("bench")

    @property
    def seeds(self) -> Tuple[int, ...]:
        return self._uniq("seed")

    def _uniq(self, field: str) -> tuple:
        return tuple(dict.fromkeys(getattr(r, field) for r in self.records))

    def __len__(self) -> int:
        return len(self.records)

    def __iter__(self) -> Iterator[RunRecord]:
        return iter(self.records)

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

    def one(self) -> SimResult:
        """The sole record's result (raises unless exactly one matches)."""
        if len(self.records) != 1:
            raise ValueError(f"expected exactly one record, have "
                             f"{len(self.records)}")
        return self.records[0].result

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

    def legacy_grid(self):
        """``run_sweep``'s shape: ``results[machine][bench]`` for one
        seed, else the seed-keyed :meth:`grid`."""
        g = self.grid()
        if len(g) == 1:
            return next(iter(g.values()))
        return g

    def summary(self) -> dict:
        """Paper-headline numbers (``runner.suite_summary``): plain floats
        for a single seed, mean/min/max bands over several."""
        from repro_torch.core.warpsim import runner
        return runner.suite_summary(self.legacy_grid())

    def bands(self) -> dict:
        """Per-metric ``{"mean", "min", "max"}`` bands over seeds
        (degenerate for a single-seed study)."""
        from repro_torch.core.warpsim import runner
        return runner.suite_summary(self.grid())

    def to_json(self) -> dict:
        """JSON-safe encoding (the reference's ``POST /study`` response)."""
        return {"records": [r.to_wire() for r in self.records],
                "stats": dict(self.stats), "backend": self.backend}

    @classmethod
    def from_json(cls, blob: Mapping,
                  backend: Optional[str] = None) -> "StudyResult":
        return cls(
            records=tuple(RunRecord.from_wire(r) for r in blob["records"]),
            stats=dict(blob.get("stats") or {}),
            backend=backend if backend is not None
            else blob.get("backend", ""))


def records_from_grid(spec: sweep_mod.SweepSpec,
                      results: Mapping) -> Tuple[RunRecord, ...]:
    """Flatten a ``run_sweep`` result (either shape) into spec-ordered
    records."""
    multi = len(spec.seeds) > 1
    return tuple(
        RunRecord(machine=mname, bench=bench, seed=seed, n_threads=n_threads,
                  result=(results[seed] if multi else results)[mname][bench])
        for mname, _cfg, bench, n_threads, seed in spec.cells())


class Session:
    """Runs studies in this process on one `device`, over its own cache
    stack.

    `cache_dir` (or an explicit `result_cache`) adds the on-disk cell
    cache; with `persist_traces` ThreadTrace snapshots land under
    ``<cache root>/traces/``. The trace and expansion LRUs are instance
    state (fresh, bounded ones unless given): studies and cells run
    through one session share traces and streams; two sessions share
    nothing but the disk.
    """

    def __init__(self, device="cuda", cache_dir: Optional[str] = None,
                 result_cache: Optional[sweep_mod.ResultCache] = None,
                 trace_cache: Optional[sweep_mod.TraceCache] = None,
                 expansion_cache: Optional[sweep_mod.ExpansionCache] = None,
                 persist_traces: bool = False):
        self.device = device
        if result_cache is None and cache_dir:
            result_cache = sweep_mod.ResultCache(cache_dir)
        self.result_cache = result_cache
        self.trace_cache = (trace_cache if trace_cache is not None
                            else sweep_mod.TraceCache())
        self.expansion_cache = (expansion_cache if expansion_cache is not None
                                else sweep_mod.ExpansionCache())
        self.persist_traces = persist_traces

    @property
    def trace_dir(self) -> Optional[str]:
        if self.persist_traces and self.result_cache is not None:
            return os.path.join(self.result_cache.root, "traces")
        return None

    def run(self, study) -> StudyResult:
        """Run a :class:`Study` (or a :class:`SweepSpec`)."""
        if isinstance(study, sweep_mod.SweepSpec):
            study = Study.from_spec(study)
        spec = study.to_spec()
        results, stats = sweep_mod.run_sweep_with_stats(
            spec, cache=self.result_cache, device=self.device,
            engine=study.engine, persist_traces=self.persist_traces,
            trace_cache=self.trace_cache,
            expansion_cache=self.expansion_cache)
        return StudyResult(records=records_from_grid(spec, results),
                           stats=stats)

    def cell(self, bench: str, machine, n_threads: Optional[int] = None,
             seed: int = 0, engine: str = "auto") -> SimResult:
        """One grid cell through the session's cache stack (a one-unit
        family launch on a miss). `machine` is a :class:`MachineConfig` or
        a preset name (``SW+``, ``ws32`` ...)."""
        cfg = (machine if isinstance(machine, MachineConfig)
               else resolve_machine_name(machine))
        key = sweep_mod.cell_key(bench, cfg, n_threads, seed)
        if self.result_cache is not None:
            hit = self.result_cache.get(key)
            if hit is not None:
                return hit
        res = sweep_mod.compute_cell(
            bench, cfg, n_threads=n_threads, seed=seed, engine=engine,
            device=self.device, trace_dir=self.trace_dir,
            trace_cache=self.trace_cache,
            expansion_cache=self.expansion_cache)
        if self.result_cache is not None:
            self.result_cache.put(key, res)
        return res

    def cache_stats(self) -> dict:
        """Live counters of the session's cache stack."""
        out = {
            "trace_cache": {
                "size": len(self.trace_cache),
                "hits": self.trace_cache.hits,
                "misses": self.trace_cache.misses,
                "disk_hits": self.trace_cache.disk_hits,
                "builds": self.trace_cache.builds,
            },
            "expansion_cache": {
                "size": len(self.expansion_cache),
                "hits": self.expansion_cache.hits,
                "misses": self.expansion_cache.misses,
            },
        }
        if self.result_cache is not None:
            out["result_cache"] = {
                "entries": self.result_cache.count(),
                "hits": self.result_cache.hits,
                "misses": self.result_cache.misses,
                "adopted": self.result_cache.adopted,
                "corrupt": self.result_cache.corrupt,
            }
        return out
