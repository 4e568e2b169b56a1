"""Warp-size sweep engine: one family launch per trace family, with
content-addressed result caching.

* :class:`SweepSpec` — a declarative bench × machine × seed grid
  (optionally a dense warp-size range, 4..128) that enumerates its cells
  in a fixed order (machines-major, benches, then seeds).
* :class:`ResultCache` — the on-disk store of :class:`SimResult` cells,
  keyed by :func:`cell_key`, a SHA-256 over ``(MODEL_VERSION, bench,
  canonical MachineConfig dict, n_threads, seed)``. Key, file layout and
  JSON are the reference's, with no engine in the key: a cache either
  package wrote serves the other.
* :class:`TraceCache` / :class:`ExpansionCache` — bounded LRUs of
  ThreadTraces and aggregated WarpStreams; the trace LRU can persist
  ``.npz`` snapshots under ``<cache root>/traces/``.
* :func:`run_sweep_with_stats` — runs the uncached cells in two levels of
  sharing:

  - **Trace families.** Expansion phase 1
    (:func:`~repro_torch.core.warpsim.divergence.build_thread_trace`)
    reads no machine field, so cells are bucketed by ``(bench, n_threads,
    seed)`` and each family builds its ThreadTrace once.
  - **Expansion keys.** Phase 2 (``aggregate_stream``, the C core) reads
    only :meth:`MachineConfig.expansion_key`, so within a family the cells
    are sub-bucketed by it and each key is aggregated once (SW+ rides on
    ws8's stream: 6 machines, 5 aggregations).

  Every (expansion key × machine) unit of a family is then simulated in
  ONE launch of the family kernels (:func:`_cuda.launch_family`). The
  launch does not wait for the card: the host builds family i+1's trace,
  streams and marshalled columns while family i's kernel runs, and reads
  family i (:func:`_cuda.collect`) after launching i+1, so at most two
  families are in flight.

The reference's process pool (and its ``parallel``, ``group_expansion``
and ``share_traces`` modes) has no counterpart: a family is one launch on
the card.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import hashlib
import json
import os
import tempfile
import threading
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

from repro_torch.core.warpsim import _cuda
from repro_torch.core.warpsim import machines as machines_mod
from repro_torch.core.warpsim import obs as obs_mod
from repro_torch.core.warpsim.config import MachineConfig
from repro_torch.core.warpsim.divergence import (
    WarpStream, aggregate_stream, build_thread_trace, expand_stream,
)
from repro_torch.core.warpsim.timing import (
    SimResult, loop_result, simulate, stream_totals,
)
from repro_torch.core.warpsim.trace import (
    BENCHMARKS, TRACE_FIELDS, ThreadTrace, Workload, get_workload,
)

# Part of every cache key: bumped whenever the simulation model changes
# observable numbers, so stale entries are never returned as current. The
# reference's value: both packages compute the same model.
MODEL_VERSION = "warpsim-2"

# SimResult fields persisted in cache entries (derived properties such as
# ipc / coalescing_rate are recomputed, never stored).
_RESULT_FIELDS = tuple(f.name for f in dataclasses.fields(SimResult))


# ---------------------------------------------------------------------------
# Cache keys
# ---------------------------------------------------------------------------


def machine_key(cfg: MachineConfig) -> str:
    """Stable content hash of a machine configuration (every field,
    the display name included)."""
    blob = json.dumps(dataclasses.asdict(cfg), sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def expansion_key(cfg: MachineConfig) -> tuple:
    """The machine fields that determine ``aggregate_stream`` output
    (:meth:`MachineConfig.expansion_key`)."""
    return cfg.expansion_key()


@functools.lru_cache(maxsize=None)
def _default_n_threads(bench: str) -> int:
    return get_workload(bench).n_threads


@functools.lru_cache(maxsize=256)
def _machine_dict(cfg: MachineConfig) -> dict:
    """Memoized ``dataclasses.asdict`` (MachineConfig is frozen)."""
    return dataclasses.asdict(cfg)


def cell_key(bench: str, cfg: MachineConfig, n_threads: Optional[int],
             seed: int) -> str:
    """Content-addressed key of one (bench, machine, n_threads, seed) cell.

    The blob is the reference's, byte for byte, so the two packages share
    one key per cell (the port's :class:`MachineConfig` has the reference's
    fields, names and order).
    """
    if n_threads is None:
        # A cell run with the bench's default thread count is the same
        # cell as one asking for that count explicitly.
        n_threads = _default_n_threads(bench.upper())
    blob = json.dumps({
        "model": MODEL_VERSION,
        "bench": bench.upper(),
        "machine": _machine_dict(cfg),
        "n_threads": n_threads,
        "seed": seed,
    }, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()


class ResultCache:
    """Content-addressed on-disk store of :class:`SimResult` cells.

    One JSON file per key, flat under `root` (cells in the two-hex-char
    shard directories of older caches stay readable). Reads that fail for
    any reason (torn write, garbage, missing or extra fields) count as
    misses and the file is quarantined under a ``.corrupt`` suffix
    (counted in :attr:`corrupt`), so a corrupt cache degrades to a cold
    one and the bad bytes survive for post-mortem.

    Existence is answered from a one-time directory listing plus this
    instance's writes; an index miss falls back to one direct probe, and a
    cell another process wrote since the listing is adopted (counted in
    :attr:`adopted`). :meth:`refresh` re-scans the directory. The index
    and counters are guarded by a lock; concurrent ``put`` calls for one
    key race benignly (results are deterministic).
    """

    def __init__(self, root: str):
        self.root = root
        self.hits = 0
        self.misses = 0
        self.adopted = 0          # index misses rescued by a direct probe
        self.corrupt = 0          # unreadable entries quarantined on read
        self._listing: Optional[set] = None
        self._legacy: Dict[str, str] = {}
        self._root_ok = False
        self._lock = threading.RLock()

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key + ".json")

    def _index(self) -> set:
        if self._listing is None:
            try:
                self._listing = set(os.listdir(self.root))
                self._root_ok = True
            except OSError:
                self._listing = set()
            # Sharded cells of older caches: flat names are 64 hex chars +
            # .json, so only shard directories have two-character names.
            for entry in [e for e in self._listing if len(e) == 2]:
                shard = os.path.join(self.root, entry)
                if not os.path.isdir(shard):
                    continue
                self._listing.discard(entry)
                try:
                    for name in os.listdir(shard):
                        self._legacy[name] = os.path.join(shard, name)
                        self._listing.add(name)
                except OSError:
                    pass
        return self._listing

    def refresh(self) -> int:
        """Re-scan the cache directory; returns the number of cells."""
        with self._lock:
            self._listing = None
            self._legacy.clear()
            return sum(1 for e in self._index() if e.endswith(".json"))

    def count(self) -> int:
        """Number of cells currently indexed (no re-scan)."""
        with self._lock:
            return sum(1 for e in self._index() if e.endswith(".json"))

    def _locate(self, name: str) -> Optional[str]:
        """Path of `name` if present, else None; adopts external writes."""
        with self._lock:
            if name in self._index():
                return self._legacy.get(name) or os.path.join(self.root, name)
            path = os.path.join(self.root, name)
            if os.path.exists(path):
                self._listing.add(name)
                self.adopted += 1
                return path
            return None

    def contains(self, key: str) -> bool:
        """Existence check without a read (and without hit/miss counting)."""
        return self._locate(key + ".json") is not None

    def get(self, key: str) -> Optional[SimResult]:
        name = key + ".json"
        path = self._locate(name)
        if path is None:
            with self._lock:
                self.misses += 1
            return None
        try:
            with open(path) as f:
                blob = json.load(f)
            fields = blob["result"]
            if set(fields) != set(_RESULT_FIELDS):
                raise ValueError("schema mismatch")
            res = SimResult(**fields)
        except FileNotFoundError:
            with self._lock:
                self._index().discard(name)
                self.misses += 1
            return None
        except Exception:
            # Corrupt entry: a miss, and the file is quarantined (renamed,
            # out of the index and the counts) rather than deleted.
            try:
                os.replace(path, path + ".corrupt")
            except OSError:
                try:
                    os.remove(path)
                except OSError:
                    pass
            with self._lock:
                self._index().discard(name)
                self._legacy.pop(name, None)
                self.misses += 1
                self.corrupt += 1
            return None
        with self._lock:
            self.hits += 1
        return res

    def put(self, key: str, result: SimResult) -> None:
        if not self._root_ok:
            os.makedirs(self.root, exist_ok=True)
            self._root_ok = True
        # A direct write: a torn one leaves a file get() quarantines and
        # re-simulates, and results are deterministic, so a lost race
        # costs a re-simulation, never wrong data.
        data = json.dumps({"key": key, "model": MODEL_VERSION,
                           "result": dataclasses.asdict(result)}).encode()
        fd = os.open(self._path(key),
                     os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        try:
            os.write(fd, data)
        finally:
            os.close(fd)
        name = key + ".json"
        with self._lock:
            self._legacy.pop(name, None)  # the flat copy supersedes it
            self._index().add(name)


# ---------------------------------------------------------------------------
# Expansion and trace LRUs
# ---------------------------------------------------------------------------


class ExpansionCache:
    """Bounded LRU of aggregated :class:`WarpStream` objects.

    Keyed by ``(bench, n_threads, seed, expansion_key)``, everything that
    determines ``aggregate_stream`` output; least-recently-used eviction
    past `maxsize`. The dict and counters are guarded by a lock, which is
    not held while a missing stream is built.
    """

    def __init__(self, maxsize: int = 64):
        self.maxsize = maxsize
        # key -> (workload, stream); the workload pins the program object
        # so the identity check below can never alias a recycled id.
        self._streams: "collections.OrderedDict[tuple, tuple]" = (
            collections.OrderedDict())
        self.hits = 0
        self.misses = 0
        self._lock = threading.Lock()

    def get(self, workload: Workload, cfg: MachineConfig,
            trace: Optional[ThreadTrace] = None,
            trace_fn=None) -> WarpStream:
        """Cached stream for ``(workload, cfg.expansion_key())``.

        On a miss the stream is aggregated from `trace` (or from calling
        `trace_fn`, resolved only on a miss), else expanded from scratch.
        """
        key = (workload.name, workload.n_threads, workload.seed,
               cfg.expansion_key())
        with self._lock:
            ent = self._streams.get(key)
            # Two hand-built workloads sharing a name must not alias one
            # stream (get_workload's are memoized and always pass).
            if ent is not None and ent[0].program is workload.program:
                self._streams.move_to_end(key)
                self.hits += 1
                return ent[1]
            self.misses += 1
        if trace is None and trace_fn is not None:
            trace = trace_fn()
        stream = (aggregate_stream(trace, cfg) if trace is not None
                  else expand_stream(workload, cfg))
        with self._lock:
            self._streams[key] = (workload, stream)
            while len(self._streams) > self.maxsize:
                self._streams.popitem(last=False)
        return stream

    def __len__(self) -> int:
        with self._lock:
            return len(self._streams)

    def clear(self) -> None:
        with self._lock:
            self._streams.clear()
            self.hits = 0
            self.misses = 0


# Part of every on-disk trace key: bumped when the snapshot encoding
# changes. The reference's value (the snapshots are interchangeable).
TRACE_VERSION = "trace-1"


def trace_key(bench: str, n_threads: int, seed: int) -> str:
    """Content-addressed key of one workload's thread trace on disk."""
    blob = json.dumps({
        "model": MODEL_VERSION,
        "trace": TRACE_VERSION,
        "bench": bench.upper(),
        "n_threads": n_threads,
        "seed": seed,
    }, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()


class TraceCache:
    """Bounded LRU of :class:`~repro_torch.core.warpsim.trace.ThreadTrace`,
    keyed by ``(bench, n_threads, seed)`` (no machine field).

    With a `root` directory, in-memory misses fall back to an ``.npz``
    snapshot (:data:`~repro_torch.core.warpsim.trace.TRACE_FIELDS`, one
    array each) and fresh builds are saved there; unreadable snapshots are
    deleted and rebuilt. Counters: ``hits``/``misses`` in memory,
    ``disk_hits`` (snapshots loaded), ``builds``.
    """

    def __init__(self, maxsize: int = 32):
        self.maxsize = maxsize
        self._traces: "collections.OrderedDict[tuple, tuple]" = (
            collections.OrderedDict())
        self.hits = 0
        self.misses = 0
        self.disk_hits = 0
        self.builds = 0
        self._lock = threading.Lock()

    def get(self, workload: Workload,
            root: Optional[str] = None) -> ThreadTrace:
        key = (workload.name, workload.n_threads, workload.seed)
        with self._lock:
            ent = self._traces.get(key)
            if ent is not None and ent[0].program is workload.program:
                self._traces.move_to_end(key)
                self.hits += 1
                hit = ent[1]
            else:
                hit = None
                self.misses += 1
        if hit is not None:
            if root and not os.path.exists(self._path(workload, root)):
                # An entry built before persistence was asked for.
                self._store(workload, root, hit)
            return hit
        trace = self._load(workload, root) if root else None
        if trace is None:
            trace = build_thread_trace(workload)
            if root:
                self._store(workload, root, trace)
            with self._lock:
                self.builds += 1
        else:
            with self._lock:
                self.disk_hits += 1
        with self._lock:
            self._traces[key] = (workload, trace)
            while len(self._traces) > self.maxsize:
                self._traces.popitem(last=False)
        return trace

    def _path(self, workload: Workload, root: str) -> str:
        return os.path.join(root, trace_key(
            workload.name, workload.n_threads, workload.seed) + ".npz")

    def _load(self, workload: Workload,
              root: str) -> Optional[ThreadTrace]:
        path = self._path(workload, root)
        try:
            with np.load(path) as data:
                if set(data.files) != set(TRACE_FIELDS):
                    raise ValueError("schema mismatch")
                return ThreadTrace(n_threads=workload.n_threads,
                                   **{f: data[f] for f in TRACE_FIELDS})
        except FileNotFoundError:
            return None
        except Exception:
            # Corrupt or stale snapshot: drop it and rebuild.
            try:
                os.remove(path)
            except OSError:
                pass
            return None

    def _store(self, workload: Workload, root: str,
               trace: ThreadTrace) -> None:
        # A private temporary file per writer, renamed into place: two
        # writers of one snapshot never interleave, the last one wins.
        path = self._path(workload, root)
        tmp = None
        try:
            os.makedirs(root, exist_ok=True)
            fd, tmp = tempfile.mkstemp(
                dir=root, prefix=os.path.basename(path) + ".", suffix=".tmp")
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **{f_: getattr(trace, f_)
                               for f_ in TRACE_FIELDS})
            os.replace(tmp, path)
        except OSError:
            if tmp is not None:
                try:
                    os.remove(tmp)
                except OSError:
                    pass

    def __len__(self) -> int:
        with self._lock:
            return len(self._traces)

    def clear(self) -> None:
        with self._lock:
            self._traces.clear()
            self.hits = self.misses = self.disk_hits = self.builds = 0


# ---------------------------------------------------------------------------
# Sweep specification
# ---------------------------------------------------------------------------


# One grid cell: (machine name, machine config, bench, n_threads, seed).
Cell = Tuple[str, MachineConfig, str, Optional[int], int]


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """A declarative bench × machine × seed grid.

    `machines` maps display name -> :class:`MachineConfig`; when omitted,
    `warp_sizes` builds plain SIMT baselines (``ws4`` … ``ws128``), and
    when both are omitted the paper's suite (ws8/16/32/64, SW+, LW+) is
    used. Cells are enumerated machines-major, benches-minor,
    seeds-innermost.
    """

    benches: Tuple[str, ...] = tuple(BENCHMARKS)
    machines: Optional[Mapping[str, MachineConfig]] = None
    warp_sizes: Tuple[int, ...] = ()
    simd_width: int = 8
    n_threads: Optional[int] = None
    seeds: Tuple[int, ...] = (0,)

    @classmethod
    def warp_size_range(cls, lo: int = 4, hi: int = 128,
                        simd_width: int = 8, **kw) -> "SweepSpec":
        """Dense power-of-two warp-size sweep, `lo`..`hi` threads/warp."""
        sizes = []
        w = lo
        while w <= hi:
            sizes.append(w)
            w *= 2
        return cls(warp_sizes=tuple(sizes), simd_width=simd_width, **kw)

    def machine_set(self) -> Dict[str, MachineConfig]:
        if self.machines is not None:
            return dict(self.machines)
        if self.warp_sizes:
            return {f"ws{w}": machines_mod.baseline(w, self.simd_width)
                    for w in self.warp_sizes}
        return machines_mod.paper_suite(self.simd_width)

    def cells(self, machine_set: Optional[Mapping[str, MachineConfig]] = None
              ) -> List[Cell]:
        """Cell list in the spec's fixed order."""
        mset = self.machine_set() if machine_set is None else machine_set
        return [(mname, cfg, b, self.n_threads, seed)
                for mname, cfg in mset.items()
                for b in self.benches
                for seed in self.seeds]


def spec_to_dict(spec: SweepSpec) -> dict:
    """JSON-safe encoding of a spec (the reference's)."""
    d = {
        "benches": list(spec.benches),
        "warp_sizes": list(spec.warp_sizes),
        "simd_width": spec.simd_width,
        "n_threads": spec.n_threads,
        "seeds": list(spec.seeds),
    }
    if spec.machines is not None:
        d["machines"] = {name: dataclasses.asdict(cfg)
                         for name, cfg in spec.machines.items()}
    return d


def spec_from_dict(d: Mapping) -> SweepSpec:
    """Inverse of :func:`spec_to_dict`.

    Absent (or null) fields take the spec defaults; a present but empty
    ``benches``/``seeds`` list is an empty grid, never the full suite.
    """
    machines = d.get("machines")
    if machines is not None:
        machines = {name: MachineConfig(**fields)
                    for name, fields in machines.items()}
    benches = d.get("benches")
    seeds = d.get("seeds")
    return SweepSpec(
        benches=tuple(BENCHMARKS) if benches is None else tuple(benches),
        machines=machines,
        warp_sizes=tuple(d.get("warp_sizes") or ()),
        simd_width=d.get("simd_width", 8),
        n_threads=d.get("n_threads"),
        seeds=(0,) if seeds is None else tuple(seeds),
    )


def _families(items: List[Tuple[Cell, Optional[str]]]
              ) -> "collections.OrderedDict[tuple, collections.OrderedDict]":
    """``(bench, n_threads, seed) -> expansion key -> [(cell, key)]``,
    first-seen order at both levels."""
    families: "collections.OrderedDict[tuple, collections.OrderedDict]" = (
        collections.OrderedDict())
    for cell, key in items:
        _mname, cfg, bench, n_threads, seed = cell
        fam = families.setdefault((bench, n_threads, seed),
                                  collections.OrderedDict())
        fam.setdefault(cfg.expansion_key(), []).append((cell, key))
    return families


def family_major_cells(cells: List[Cell]) -> List[Cell]:
    """Reorder cells family-major: trace family ``(bench, n_threads,
    seed)``, then expansion key within the family, preserving first-seen
    order of both."""
    return [cell for fam in _families([(c, None) for c in cells]).values()
            for group in fam.values() for cell, _key in group]


# ---------------------------------------------------------------------------
# Execution
# ---------------------------------------------------------------------------


def compute_cell(bench: str, cfg: MachineConfig,
                 n_threads: Optional[int] = None, seed: int = 0,
                 engine: str = "auto", device="cuda",
                 trace_dir: Optional[str] = None,
                 trace_cache: Optional[TraceCache] = None,
                 expansion_cache: Optional[ExpansionCache] = None
                 ) -> SimResult:
    """Simulate one grid cell (a one-unit family launch) through the
    trace/expansion LRUs (fresh ones when omitted), with trace snapshots
    under `trace_dir` when given.

    The cell-at-a-time path of the sweep service, its queue workers and
    ``api.Session.cell``. Its stages are timed into the ambient
    observability domain under the reference's names (``trace_build``,
    ``aggregate``, ``engine``).
    """
    tcache = TraceCache() if trace_cache is None else trace_cache
    ecache = ExpansionCache() if expansion_cache is None else expansion_cache
    wl = get_workload(bench, n_threads=n_threads, seed=seed)

    def build_trace():
        with obs_mod.stage("trace_build", bench=wl.name):
            return tcache.get(wl, root=trace_dir)

    with obs_mod.stage("aggregate", bench=bench):
        stream = ecache.get(wl, cfg, trace_fn=build_trace)
    with obs_mod.stage("engine", engine=engine, bench=bench):
        return simulate(wl.name, stream, cfg, engine=engine, device=device)


def run_sweep(spec: SweepSpec, cache: Optional[ResultCache] = None,
              device="cuda", engine: str = "auto",
              persist_traces: bool = False,
              trace_cache: Optional[TraceCache] = None,
              expansion_cache: Optional[ExpansionCache] = None):
    """:func:`run_sweep_with_stats` without the stats."""
    results, _stats = run_sweep_with_stats(
        spec, cache=cache, device=device, engine=engine,
        persist_traces=persist_traces, trace_cache=trace_cache,
        expansion_cache=expansion_cache)
    return results


def run_sweep_with_stats(
    spec: SweepSpec,
    cache: Optional[ResultCache] = None,
    device="cuda",
    engine: str = "auto",
    persist_traces: bool = False,
    trace_cache: Optional[TraceCache] = None,
    expansion_cache: Optional[ExpansionCache] = None,
) -> Tuple[Dict, Dict[str, int]]:
    """Run a sweep grid; returns ``(results, stats)``.

    ``results[machine][bench] -> SimResult`` for a one-seed spec, else
    ``results[seed][machine][bench]``, in the spec's order (the
    reference's shapes). Cells found in `cache` are not simulated; the
    rest run one family launch per trace family (see the module
    docstring), and their results are written to `cache`. With
    ``persist_traces=True`` (and a `cache`) traces are also saved under
    ``<cache root>/traces/`` and loaded by later runs.

    `stats` holds the reference's keys: ``cells``, ``cache_hits``,
    ``cache_misses``, ``simulated``, ``peer_hits`` (0: there is no mesh),
    ``expansion_groups``, ``expansions_saved``, ``trace_families``,
    ``traces_shared``, ``family_launches`` (one per simulated family: a
    fully cached run launches nothing) and the LRU deltas
    (``expansion_cache_*``, ``trace_cache_*``, ``trace_disk_hits``).
    `trace_cache`/`expansion_cache` are the LRUs to use (fresh ones when
    omitted).

    ``engine="cuda"`` (the family kernels) needs a CUDA `device`;
    ``engine="torch"`` (their plain versions) runs on the CPU.
    """
    engine = _cuda.resolve_engine(engine, device)
    tcache = TraceCache() if trace_cache is None else trace_cache
    ecache = ExpansionCache() if expansion_cache is None else expansion_cache
    mset = spec.machine_set()
    cells = spec.cells(machine_set=mset)
    results: Dict[int, Dict[str, Dict[str, SimResult]]] = {
        seed: {} for seed in spec.seeds}
    exp_hits0, exp_miss0 = ecache.hits, ecache.misses
    trc_hits0, trc_miss0 = tcache.hits, tcache.misses
    trc_disk0 = tcache.disk_hits

    hits = 0
    todo: List[Tuple[Cell, Optional[str]]] = []
    for cell in cells:
        _mname, cfg, bench, n_threads, seed = cell
        key = (cell_key(bench, cfg, n_threads, seed)
               if cache is not None else None)
        cached = cache.get(key) if cache is not None else None
        if cached is not None:
            hits += 1
            results[seed].setdefault(cell[0], {})[bench] = cached
        else:
            todo.append((cell, key))

    families = _families(todo)
    trace_dir = (os.path.join(cache.root, "traces")
                 if cache is not None and persist_traces else None)

    def scatter(launch, groups, name: str) -> None:
        raw = _cuda.collect(launch)
        i = 0
        for stream, members in groups:
            totals = stream_totals(stream)
            for (mname, cfg, bench, _n, seed), key in members:
                res = loop_result(name, cfg, raw[i], totals)
                i += 1
                results[seed].setdefault(mname, {})[bench] = res
                if cache is not None:
                    cache.put(key, res)

    # Family i+1's host stages run while family i's launch does; family i
    # is read after i+1 is launched, so at most two are in flight.
    pending = None
    for (bench, n_threads, seed), fam in families.items():
        wl = get_workload(bench, n_threads=n_threads, seed=seed)
        groups = []
        pairs = []
        for members in fam.values():
            stream = ecache.get(
                wl, members[0][0][1],
                trace_fn=lambda wl=wl: tcache.get(wl, root=trace_dir))
            groups.append((stream, members))
            pairs.extend((stream, cell[1]) for cell, _key in members)
        launch = _cuda.launch_family(pairs, device, engine)
        if pending is not None:
            scatter(*pending)
        pending = (launch, groups, wl.name)
    if pending is not None:
        scatter(*pending)

    n_groups = sum(len(fam) for fam in families.values())
    stats = dict(
        cells=len(cells),
        cache_hits=hits,
        cache_misses=len(todo) if cache is not None else 0,
        simulated=len(todo),
        peer_hits=0,
        expansion_groups=n_groups,
        expansions_saved=len(todo) - n_groups,
        trace_families=len(families),
        traces_shared=n_groups - len(families),
        family_launches=len(families),
        expansion_cache_hits=ecache.hits - exp_hits0,
        expansion_cache_misses=ecache.misses - exp_miss0,
        trace_cache_hits=tcache.hits - trc_hits0,
        trace_cache_misses=tcache.misses - trc_miss0,
        trace_disk_hits=tcache.disk_hits - trc_disk0,
    )
    ordered = {seed: {mname: {b: results[seed][mname][b]
                              for b in spec.benches}
                      for mname in mset}
               for seed in spec.seeds}
    if len(spec.seeds) == 1:
        return ordered[spec.seeds[0]], stats
    return ordered, stats
