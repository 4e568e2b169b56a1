"""The facade of the warp-size study: Study, StudyResult, backends, Session.

* :class:`Study` — a declarative bench × machine × seed grid (or a dense
  warp-size range) plus the timing `engine` (``"cuda"``: the family
  kernels; ``"torch"``: their plain versions on the CPU; ``"auto"``:
  whichever the device runs; ``"native"``, ``"fast"``, ``"fast_nested"``,
  ``"event"``: the host engines, on the host CPU). JSON-safe via
  :meth:`Study.to_dict` / :meth:`Study.from_dict`, in the reference's
  encoding (the sweep service's ``POST /study`` body).
* :class:`StudyResult` — flat :class:`RunRecord` tuples in the study's
  fixed cell order, the run's stats, and accessors (:meth:`~StudyResult.by`,
  :meth:`~StudyResult.one`, :meth:`~StudyResult.per_bench`,
  :meth:`~StudyResult.grid`, :meth:`~StudyResult.summary`,
  :meth:`~StudyResult.bands`, :meth:`~StudyResult.to_json`).
* :class:`Backend` — where a study runs: :class:`InProcessBackend` (this
  process, one family launch per trace family on the session's device, or
  a host engine, serially or in a process pool),
  :class:`ServiceBackend` (a running sweep daemon, ``POST /study``) and
  :class:`QueueBackend` (enqueue on a daemon, drain through the work
  queue's worker loop on the session's device). All three give the same
  records, bit for bit, as the reference's.
* :class:`Session` — runs studies through its backend and owns the cache
  stack: an optional on-disk :class:`~repro_torch.core.warpsim.sweep.
  ResultCache` (`cache_dir`), shared with the reference package (same
  keys, same files), and the session's own trace and expansion LRUs. It
  computes on one device (``"cuda"`` unless the caller asks for
  ``"cpu"``).

Usage::

    from repro_torch.core.warpsim import api
    session = api.Session(cache_dir="benchmarks/results/torch/sweep_cache")
    res = session.run(api.Study(seeds=(0, 1, 2)))
    res.summary()["swplus_over_lwplus"]      # mean/min/max over seeds
    session.cell("BFS", "SW+").ipc           # one cell, cached

    api.Session(backend=api.ServiceBackend("http://127.0.0.1:8321"))
    api.Session.from_env(cache_dir=...)      # a live $WARPSIM_SERVICE_URL
                                             # daemon, else in-process

``WARPSIM_BACKEND`` (``inprocess`` | ``service`` | ``queue``) forces the
:meth:`Session.from_env` choice, as in the reference.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Dict, Iterator, Mapping, Optional, Tuple

from repro_torch.core.warpsim import envcfg
from repro_torch.core.warpsim import machines as machines_mod
from repro_torch.core.warpsim import obs as obs_mod
from repro_torch.core.warpsim import sweep as sweep_mod
from repro_torch.core.warpsim.config import MachineConfig
# Typed client errors, re-exported at the facade boundary: callers catch
# api.ServiceError / api.ServiceUnavailable.
from repro_torch.core.warpsim.faults import (  # noqa: F401 — re-exports
    FaultPlan, ServiceError, ServiceUnavailable,
)
from repro_torch.core.warpsim.timing import SimResult
from repro_torch.core.warpsim.trace import BENCHMARKS

ENV_BACKEND = "WARPSIM_BACKEND"


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


# ---------------------------------------------------------------------------
# Backends
# ---------------------------------------------------------------------------


class Backend:
    """Execution protocol: turn a :class:`Study` into a :class:`StudyResult`.

    Implementations receive the owning :class:`Session` so they can use
    its cache stack and device (the in-process and queue backends do; the
    service backend delegates both to the daemon it talks to). Records
    are bit-identical across backends for the same study: results are
    deterministic and content-addressed, so *where* a cell was computed
    can never change *what* it is.
    """

    name = "abstract"

    def run(self, study: Study, session: "Session") -> StudyResult:
        raise NotImplementedError


class InProcessBackend(Backend):
    """This process, through the session's caches: one family launch per
    trace family on the session's device, or a host engine serially or in
    a process pool (the sweep's modes: `parallel`, `max_workers`,
    `group_expansion`, `reuse_expansion`, `share_traces`, as
    ``sweep.run_sweep_with_stats`` takes them).

    `result_cache` (when given) overrides the session's (the
    ``runner.run_suite(cache=...)`` contract rides through here).
    """

    name = "inprocess"

    def __init__(self, parallel: Optional[bool] = None,
                 max_workers: Optional[int] = None,
                 group_expansion: bool = True,
                 reuse_expansion: bool = True,
                 share_traces: bool = True,
                 result_cache: Optional[sweep_mod.ResultCache] = None):
        self.parallel = parallel
        self.max_workers = max_workers
        self.group_expansion = group_expansion
        self.reuse_expansion = reuse_expansion
        self.share_traces = share_traces
        self.result_cache = result_cache

    def run(self, study: Study, session: "Session") -> StudyResult:
        spec = study.to_spec()
        cache = (self.result_cache if self.result_cache is not None
                 else session.result_cache)
        results, stats = sweep_mod.run_sweep_with_stats(
            spec, cache=cache, parallel=self.parallel,
            max_workers=self.max_workers, engine=study.engine,
            group_expansion=self.group_expansion,
            reuse_expansion=self.reuse_expansion,
            share_traces=self.share_traces,
            persist_traces=session.persist_traces,
            trace_cache=session.trace_cache,
            expansion_cache=session.expansion_cache,
            device=session.device)
        return StudyResult(records=records_from_grid(spec, results),
                           stats=stats, backend=self.name)


class ServiceBackend(Backend):
    """A running sweep daemon (``POST /study``): its cache, its LRUs, its
    device. The daemon may be the port's or the reference's: the wire
    forms are the same.

    `urls` (a list, or one comma-separated string) builds a
    :class:`~repro_torch.core.warpsim.service.ResilientClient` over the
    fleet instead of a single-daemon
    :class:`~repro_torch.core.warpsim.service.SweepClient`.
    """

    name = "service"

    def __init__(self, url: Optional[str] = None, client=None,
                 timeout: float = 600.0, urls=None):
        if client is None and not url and not urls:
            raise ValueError("ServiceBackend needs a url, urls, or a client")
        self._client = client
        if isinstance(urls, str):
            urls = [u.strip() for u in urls.split(",") if u.strip()]
        self.urls = list(urls) if urls else None
        self.url = (url if url
                    else (self.urls[0] if self.urls else client.base_url))
        self.timeout = timeout

    def client(self):
        if self._client is None:
            from repro_torch.core.warpsim import service as service_mod
            if self.urls:
                self._client = service_mod.ResilientClient(
                    self.urls, timeout=self.timeout)
            else:
                self._client = service_mod.SweepClient(self.url,
                                                       timeout=self.timeout)
        return self._client

    def run(self, study: Study, session: "Session") -> StudyResult:
        res = self.client().study(study)
        return dataclasses.replace(res, backend=self.name)


class QueueBackend(Backend):
    """Enqueue on a daemon, drain through the work-queue worker loop.

    The daemon shards the study's *uncached* cells onto a lease-based
    job, this process drains it as a worker on the session's device
    (other workers on other hosts may drain it concurrently — leases keep
    them from colliding), and the finished study is then fetched from the
    daemon's cache. `stats` additionally carries ``queue_job`` and
    ``queue_cells_computed`` (cells *this* worker simulated).
    """

    name = "queue"

    def __init__(self, url: Optional[str] = None, chunk_size: int = 16,
                 lease_seconds: Optional[float] = None,
                 worker_id: Optional[str] = None,
                 poll_seconds: float = 0.05, timeout: float = 600.0,
                 client=None):
        if client is None and not url:
            raise ValueError("QueueBackend needs a url or a client")
        self._client = client
        self.url = url if url else client.base_url
        self.chunk_size = chunk_size
        self.lease_seconds = lease_seconds
        self.worker_id = worker_id
        self.poll_seconds = poll_seconds
        self.timeout = timeout

    def client(self):
        if self._client is None:
            from repro_torch.core.warpsim import service as service_mod
            self._client = service_mod.SweepClient(self.url,
                                                   timeout=self.timeout)
        return self._client

    def run(self, study: Study, session: "Session") -> StudyResult:
        from repro_torch.core.warpsim import work_queue as wq_mod
        client = self.client()
        job = client.enqueue(study.to_spec(), chunk_size=self.chunk_size,
                             lease_seconds=self.lease_seconds)
        # Drain against the whole fleet, starting with the endpoint that
        # took the enqueue (for a ResilientClient, last_url).
        worker_urls = [getattr(client, "last_url", None) or self.url]
        for u in getattr(client, "urls", ()):
            if u not in worker_urls:
                worker_urls.append(u)
        computed = wq_mod.run_worker(
            worker_urls, job["job"], worker_id=self.worker_id,
            engine=study.engine, device=session.device,
            poll_seconds=self.poll_seconds, timeout=self.timeout)
        res = client.study(study)       # every cell now a daemon cache hit
        stats = dict(res.stats, queue_job=job["job"],
                     queue_cells_computed=computed)
        return StudyResult(records=res.records, stats=stats,
                           backend=self.name)


# ---------------------------------------------------------------------------
# Session: owns the cache stack, runs studies
# ---------------------------------------------------------------------------


class Session:
    """Runs studies through its `backend` (in this process unless given),
    on one `device`, over its own cache stack.

    `cache_dir` (or an explicit `result_cache`) adds the on-disk cell
    cache; with `persist_traces` ThreadTrace snapshots land under
    ``<cache root>/traces/``. The trace and expansion LRUs are instance
    state (fresh, bounded ones unless given): studies and cells run
    through one session share traces and streams; two sessions share
    nothing but the disk. `device` is where this process computes: the
    in-process backend's studies, :meth:`cell`, and the cells a
    :class:`QueueBackend` drains.
    """

    def __init__(self, device="cuda", cache_dir: Optional[str] = None,
                 result_cache: Optional[sweep_mod.ResultCache] = None,
                 trace_cache: Optional[sweep_mod.TraceCache] = None,
                 expansion_cache: Optional[sweep_mod.ExpansionCache] = None,
                 persist_traces: bool = False,
                 backend: Optional[Backend] = None):
        self.device = device
        self.backend = backend if backend is not None else InProcessBackend()
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

    def run(self, study, backend: Optional[Backend] = None) -> StudyResult:
        """Run a :class:`Study` (or a :class:`SweepSpec`) through `backend`
        (default: the session's).

        Every run is one trace: remote backends propagate its id over the
        ``X-Warpsim-Op`` header, so a study's hops across daemons
        reassemble from their ``/debug/trace`` dumps.
        """
        if isinstance(study, sweep_mod.SweepSpec):
            study = Study.from_spec(study)
        b = backend if backend is not None else self.backend
        with obs_mod.start_trace("study", backend=b.name):
            return b.run(study, self)

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

    @classmethod
    def from_env(cls, cache_dir: Optional[str] = None,
                 persist_traces: bool = False, device="cuda") -> "Session":
        """The environment-driven session (figure generation).

        ``WARPSIM_BACKEND`` forces a backend (``inprocess`` | ``service``
        | ``queue``; the remote two require ``WARPSIM_SERVICE_URLS`` — a
        comma-separated fleet, served through a failover
        ``ResilientClient`` — or single-daemon ``WARPSIM_SERVICE_URL``,
        and raise when both are absent or everything is dead). Unset, a
        live fleet/daemon from those variables is preferred (probed via
        ``service.from_env``, which warns once per process on a dead URL)
        with a fall back to an in-process session over `cache_dir` on
        `device`. The reference's rules, on the port's clients.
        """
        from repro_torch.core.warpsim import service as service_mod
        choice = (envcfg.get(ENV_BACKEND) or "").strip().lower() or None
        if choice in ("inprocess", "in-process", "local"):
            return cls(device=device, cache_dir=cache_dir,
                       persist_traces=persist_traces)
        if choice in ("queue", "service"):
            fleet = (envcfg.get(service_mod.ENV_URLS) or "").strip()
            url = envcfg.get(service_mod.ENV_URL)
            if not fleet and not url:
                raise ValueError(
                    f"{ENV_BACKEND}={choice} requires {service_mod.ENV_URL} "
                    f"or {service_mod.ENV_URLS}")
            try:
                if fleet:
                    client = service_mod.ResilientClient(fleet)
                else:
                    client = service_mod.SweepClient(url)
                client.healthz()
            except ServiceError as e:
                var, val = ((service_mod.ENV_URLS, fleet) if fleet
                            else (service_mod.ENV_URL, url))
                raise RuntimeError(
                    f"{ENV_BACKEND}={choice} but no live daemon at "
                    f"{var}={val!r} "
                    f"({e.__class__.__name__}: {e})") from e
            backend = (QueueBackend(client=client) if choice == "queue"
                       else ServiceBackend(client=client))
            return cls(device=device, backend=backend)
        if choice is not None:
            raise ValueError(
                f"{ENV_BACKEND}={choice!r}: expected inprocess | service "
                f"| queue")
        client = service_mod.from_env()
        if client is not None:
            return cls(device=device, backend=ServiceBackend(client=client))
        return cls(device=device, cache_dir=cache_dir,
                   persist_traces=persist_traces)


_DEFAULT_LOCK = threading.Lock()
_DEFAULT_SESSION: Optional[Session] = None


def default_session() -> Session:
    """The process-wide in-process session on the card: one set of
    trace/expansion LRUs shared by the callers that use it. New code
    should build its own :class:`Session` (or :meth:`Session.from_env`).
    """
    global _DEFAULT_SESSION
    with _DEFAULT_LOCK:
        if _DEFAULT_SESSION is None:
            _DEFAULT_SESSION = Session()
        return _DEFAULT_SESSION
