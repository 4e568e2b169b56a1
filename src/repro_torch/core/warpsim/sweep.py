"""Warp-size sweep engine: the reference's modes, with one family launch
per trace family on the card, and content-addressed result caching.

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
  ``.npz`` snapshots under ``<cache root>/traces/``. A run uses the LRUs
  its caller passes (fresh ones when omitted); process-pool workers use
  their process's :data:`TRACE_CACHE` and :data:`EXPANSION_CACHE`.
* :func:`run_sweep_with_stats` — runs the uncached cells in two levels of
  sharing:

  - **Trace families.** Expansion phase 1
    (:func:`~repro_torch.core.warpsim.divergence.build_thread_trace`)
    reads no machine field, so cells are bucketed by ``(bench, n_threads,
    seed)`` and each family builds its ThreadTrace once.
  - **Expansion keys.** Phase 2 (``aggregate_stream``, the C core) reads
    only :meth:`MachineConfig.expansion_key`, so within a family the cells
    are sub-bucketed by it and each key is aggregated once (SW+ rides on
    ws8's stream: 6 machines, 5 aggregations). One expansion-key group is
    one unit of work.

  With the family engines (``"cuda"``, the card's kernels, and
  ``"torch"``, their plain versions; ``"auto"`` is one of them) every
  unit of a family is simulated in ONE launch
  (:func:`_cuda.launch_family`). The launch does not wait for the card:
  the host builds family i+1's trace, streams and marshalled columns
  while family i's kernel runs, and reads family i (:func:`_cuda.collect`)
  after launching i+1, so at most two families are in flight. The
  family engines never use a process pool: the launch replaces it.

  With a host engine (``timing.HOST_ENGINES``: ``native``, ``fast``,
  ``fast_nested``, ``event``) each unit is run by :func:`_run_group`,
  serially or in a process pool (``parallel``, ``max_workers``; by
  default the pool runs when there are at least 4 units and 4 CPUs, or
  2 CPUs and an engine slower than ``native``, the reference's rule).
  The pool starts its workers with ``forkserver``, never ``fork`` (the
  parent may hold a CUDA context and threads); they import no torch, and
  the C cores are built in the parent before it starts, so the workers
  only load them. Results keep the spec's order whatever order the
  workers finish in.

  The reference's baseline modes come over with it:
  ``share_traces=False`` expands each group in one single-phase walk
  (``sweep_bench``'s ``cold_pr2``), ``group_expansion=False`` makes each
  cell its own unit (a one-unit family launch per cell with a family
  engine) and ``reuse_expansion=False`` bypasses every LRU (with both,
  ``sweep_bench``'s ``cold_pr1``).

``LAST_SWEEP_STATS`` is the reference's deprecated alias of the last
run's stats (reading it warns); :func:`run_sweep_with_stats` returns each
run's own.
"""

from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import functools
import hashlib
import json
import multiprocessing
import os
import sys
import tempfile
import threading
import warnings
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

from repro_torch.core.warpsim import _native
from repro_torch.core.warpsim import machines as machines_mod
from repro_torch.core.warpsim import obs as obs_mod
from repro_torch.core.warpsim.config import MachineConfig
from repro_torch.core.warpsim.divergence import (
    WarpStream, aggregate_stream, build_thread_trace, expand_stream,
    expand_stream_single,
)
from repro_torch.core.warpsim.timing import (
    HOST_ENGINES, SimResult, loop_result, simulate, stream_totals,
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
            trace_fn=None,
            single_phase: bool = False) -> WarpStream:
        """Cached stream for ``(workload, cfg.expansion_key())``.

        On a miss the stream is aggregated from `trace` (or from calling
        `trace_fn`, resolved only on a miss), else built by the
        single-phase walk when ``single_phase=True`` (the ``cold_pr2``
        baseline), else expanded from scratch in two phases.
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
        if trace is not None:
            stream = aggregate_stream(trace, cfg)
        elif single_phase:
            stream = expand_stream_single(workload, cfg)
        else:
            stream = expand_stream(workload, cfg)
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


EXPANSION_CACHE_SIZE = 64
#: This process's expansion LRU: the one pool workers use.
EXPANSION_CACHE = ExpansionCache(EXPANSION_CACHE_SIZE)


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


TRACE_CACHE_SIZE = 32
#: This process's trace LRU: the one pool workers use.
TRACE_CACHE = TraceCache(TRACE_CACHE_SIZE)

# The deprecated alias: the stats of the last run in this process, one
# dict updated in place (callers import it by value). Reads go through
# the module ``__getattr__`` below, which warns.
_LAST_SWEEP_STATS: Dict[str, int] = {}  # guarded-by: _STATS_LOCK
_STATS_LOCK = threading.Lock()


def __getattr__(name: str):
    if name == "LAST_SWEEP_STATS":
        warnings.warn(
            "sweep.LAST_SWEEP_STATS is deprecated: it is overwritten by "
            "every concurrent sweep in the process. Use "
            "run_sweep_with_stats() (or api.Session.run(...).stats) for a "
            "per-run snapshot.", DeprecationWarning, stacklevel=2)
        return _LAST_SWEEP_STATS
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


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


#: The engines that simulate a trace family in one launch; they never use
#: a process pool.
FAMILY_ENGINES = ("cuda", "torch")
#: How the pool starts its workers: not ``fork``, since the parent may
#: hold a CUDA context and threads (the pipelined launches, the service's).
POOL_START_METHOD = "forkserver"

# One unit of worker work: (bench, n_threads, seed, [configs sharing one
# expansion key], engine, reuse_expansion, share_trace, trace_dir), the
# reference's payload. Payloads are ordered family-major, so a pool's
# chunks keep a family's groups in one worker, whose trace LRU builds the
# family's trace once.
_GroupPayload = Tuple[str, Optional[int], int, List[MachineConfig], str,
                      bool, bool, Optional[str]]


def pool_context():
    """The multiprocessing context of the sweep's process pool: the
    ``forkserver`` start method, whose server imports this module and the
    pool's worker loop (``concurrent.futures.process``) once, so each
    worker starts as a fork of a process that holds no CUDA context, no
    threads and no torch.

    multiprocessing still runs the caller's main script again in each
    worker, as ``__mp_main__`` (the server does not preload it), so a
    script needs a ``__main__`` guard, and its top level is part of every
    worker's start; a ``-c`` program or an interactive session has none.
    The server finds this module on ``PYTHONPATH`` or among the installed
    packages: CPython 3.12.3's server ignores a ``sys.path`` entry made at
    run time (3.12.12's applies it), and then each worker imports the port
    itself.
    """
    ctx = multiprocessing.get_context(POOL_START_METHOD)
    ctx.set_forkserver_preload(["concurrent.futures.process", __name__])
    return ctx


def pool_probe(_arg=None) -> Tuple[int, bool]:
    """A pool worker's ``(pid, whether torch is imported)``: what a caller
    maps over a fresh pool to time its start and to check that workers
    import no torch."""
    return os.getpid(), "torch" in sys.modules


def _run_group(args: _GroupPayload,
               trace_cache: Optional[TraceCache] = None,
               expansion_cache: Optional[ExpansionCache] = None,
               device="cpu") -> List[SimResult]:
    """Worker: resolve one expansion key's stream, simulate every member.

    Top-level so a pool can pickle it. The stream comes through
    :func:`_group_stream` (the payload's reuse and share flags ride in it,
    so they reach workers under any start method). `trace_cache` /
    `expansion_cache` default to this process's :data:`TRACE_CACHE` and
    :data:`EXPANSION_CACHE` (what pool workers use); a serial sweep passes
    its own. `device` is read only by the family engines (a one-unit
    launch per cell when ``group_expansion=False``).
    """
    tcache = TRACE_CACHE if trace_cache is None else trace_cache
    ecache = EXPANSION_CACHE if expansion_cache is None else expansion_cache
    wl, stream = _group_stream(args, tcache, ecache)
    engine = args[4]
    ops = stream.to_warp_ops() if engine == "event" else stream
    out = []
    for cfg in args[3]:
        with obs_mod.stage("engine", engine=engine, bench=wl.name):
            out.append(simulate(wl.name, ops, cfg, engine=engine,
                                device=device))
    return out


def _group_stream(args: _GroupPayload, tcache: TraceCache,
                  ecache: ExpansionCache) -> Tuple[Workload, WarpStream]:
    """One payload's workload and aggregated stream, through the LRUs when
    the payload reuses them (shared by the per-group path and the family
    launches)."""
    bench, n_threads, seed, cfgs, _engine, reuse, share, tdir = args
    wl = get_workload(bench, n_threads=n_threads, seed=seed)
    # The aggregate stage covers the expansion-LRU resolution; a cold
    # trace build nests its trace_build stage inside it.
    with obs_mod.stage("aggregate", bench=bench):
        if reuse:
            if share:
                stream = ecache.get(
                    wl, cfgs[0],
                    trace_fn=lambda: _traced_build(tcache, wl, tdir))
            else:
                stream = ecache.get(wl, cfgs[0], single_phase=True)
        else:
            stream = (expand_stream(wl, cfgs[0]) if share
                      else expand_stream_single(wl, cfgs[0]))
    return wl, stream


def _traced_build(tcache: TraceCache, wl: Workload,
                  root: Optional[str]) -> ThreadTrace:
    """Trace-LRU resolve under the ``trace_build`` stage (reached only on
    an expansion-LRU miss)."""
    with obs_mod.stage("trace_build", bench=wl.name):
        return tcache.get(wl, root=root)


def compute_cell(bench: str, cfg: MachineConfig,
                 n_threads: Optional[int] = None, seed: int = 0,
                 engine: str = "auto", device="cuda",
                 trace_dir: Optional[str] = None,
                 trace_cache: Optional[TraceCache] = None,
                 expansion_cache: Optional[ExpansionCache] = None
                 ) -> SimResult:
    """Simulate one grid cell (a one-unit family launch, or a host
    engine's run) through the trace/expansion LRUs (fresh ones when
    omitted), with trace snapshots under `trace_dir` when given.

    The cell-at-a-time path of the sweep service, its queue workers and
    ``api.Session.cell``. Its stages are timed into the ambient
    observability domain under the reference's names (``trace_build``,
    ``aggregate``, ``engine``).
    """
    tcache = TraceCache() if trace_cache is None else trace_cache
    ecache = ExpansionCache() if expansion_cache is None else expansion_cache
    wl = get_workload(bench, n_threads=n_threads, seed=seed)
    with obs_mod.stage("aggregate", bench=bench):
        stream = ecache.get(
            wl, cfg, trace_fn=lambda: _traced_build(tcache, wl, trace_dir))
    with obs_mod.stage("engine", engine=engine, bench=bench):
        return simulate(wl.name, stream, cfg, engine=engine, device=device)


def run_sweep(
    spec: SweepSpec,
    cache: Optional[ResultCache] = None,
    parallel: Optional[bool] = None,
    max_workers: Optional[int] = None,
    engine: str = "auto",
    group_expansion: bool = True,
    reuse_expansion: bool = True,
    share_traces: bool = True,
    persist_traces: bool = False,
    trace_cache: Optional[TraceCache] = None,
    expansion_cache: Optional[ExpansionCache] = None,
    device="cuda",
):
    """:func:`run_sweep_with_stats` without the stats."""
    results, _stats = run_sweep_with_stats(
        spec, cache=cache, parallel=parallel, max_workers=max_workers,
        engine=engine, group_expansion=group_expansion,
        reuse_expansion=reuse_expansion, share_traces=share_traces,
        persist_traces=persist_traces, trace_cache=trace_cache,
        expansion_cache=expansion_cache, device=device)
    return results


def run_sweep_with_stats(
    spec: SweepSpec,
    cache: Optional[ResultCache] = None,
    parallel: Optional[bool] = None,
    max_workers: Optional[int] = None,
    engine: str = "auto",
    group_expansion: bool = True,
    reuse_expansion: bool = True,
    share_traces: bool = True,
    persist_traces: bool = False,
    trace_cache: Optional[TraceCache] = None,
    expansion_cache: Optional[ExpansionCache] = None,
    device="cuda",
) -> Tuple[Dict, Dict[str, int]]:
    """Run a sweep grid; returns ``(results, stats)``.

    ``results[machine][bench] -> SimResult`` for a one-seed spec, else
    ``results[seed][machine][bench]``, in the spec's order (the
    reference's shapes). Cells found in `cache` are not simulated; the
    rest run as the module docstring says, and their results are written
    to `cache`. With ``persist_traces=True`` (and a `cache`, sharing and
    reuse on) traces are also saved under ``<cache root>/traces/`` and
    loaded by later runs.

    `engine`: ``"cuda"`` (the family kernels) needs a CUDA `device`;
    ``"torch"`` (their plain versions) runs on the CPU; ``"auto"``
    resolves from `device`; the host engines (``native``, ``fast``,
    ``fast_nested``, ``event``) run on the host CPU whatever the device.
    `parallel` forces (True) or forbids (False) the process pool of the
    host engines, `max_workers` sizes it (default: one worker a CPU, at
    most one a unit); the family engines never use it.
    `group_expansion`, `reuse_expansion` and `share_traces` are the
    reference's modes (module docstring).

    `stats` holds the reference's keys: ``cells``, ``cache_hits``,
    ``cache_misses``, ``simulated``, ``peer_hits`` (0: there is no mesh),
    ``expansion_groups``, ``expansions_saved``, ``trace_families``,
    ``traces_shared`` (0 without shared traces), ``family_launches`` (one
    per simulated family with a family engine and grouping on; else 0)
    and the LRU deltas of this process (``expansion_cache_*``,
    ``trace_cache_*``, ``trace_disk_hits``; a pool's workers keep their
    own). `trace_cache`/`expansion_cache` are the LRUs to use (fresh ones
    when omitted).
    """
    if engine not in HOST_ENGINES:
        # The family engines' module imports torch: only a run that
        # launches them imports it.
        from repro_torch.core.warpsim import _cuda
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
    if cache is None:
        todo: List[Tuple[Cell, Optional[str]]] = [(c, None) for c in cells]
    else:
        todo = []
        with obs_mod.stage("result_lookup", cells=len(cells)):
            for cell in cells:
                _mname, cfg, bench, n_threads, seed = cell
                key = cell_key(bench, cfg, n_threads, seed)
                cached = cache.get(key)
                if cached is not None:
                    hits += 1
                    results[seed].setdefault(cell[0], {})[bench] = cached
                else:
                    todo.append((cell, key))

    with obs_mod.stage("plan", cells=len(todo)):
        if not group_expansion:
            share_traces = False     # one cell a unit: nothing to share
        # Trace family (bench, n_threads, seed), then expansion key within
        # it; without grouping every cell is a family and a group of its
        # own.
        if group_expansion:
            families = _families(todo)
        else:
            families = collections.OrderedDict(
                ((i,), collections.OrderedDict([(i, [item])]))
                for i, item in enumerate(todo))
        n_groups = sum(len(fam) for fam in families.values())
        trace_dir = (os.path.join(cache.root, "traces")
                     if cache is not None and share_traces
                     and reuse_expansion and persist_traces else None)
        payloads: List[_GroupPayload] = []
        grp_members: List[List[Tuple[Cell, Optional[str]]]] = []
        fam_sizes: List[int] = []
        for fam in families.values():
            fam_sizes.append(len(fam))
            for members in fam.values():
                first = members[0][0]
                payloads.append((first[2], first[3], first[4],
                                 [cell[1] for cell, _key in members],
                                 engine, reuse_expansion, share_traces,
                                 trace_dir))
                grp_members.append(members)

    def scatter(members, group_res) -> None:
        for (cell, key), res in zip(members, group_res):
            mname, _cfg, bench, _n, seed = cell
            results[seed].setdefault(mname, {})[bench] = res
            if cache is not None:
                cache.put(key, res)

    if engine == "native" and payloads:
        # Built here, once, before any pool starts: workers only load it.
        _native.load_loop()
    ncpu = os.cpu_count() or 1
    if engine in FAMILY_ENGINES:
        parallel = False         # a family launch replaces the pool
    elif parallel is None:
        # The reference's rule: a pool pays off when there is work per
        # unit next to its start; a native cell is cheap, so below 4 CPUs
        # it stays serial, while the Python engines take a second core.
        cells_are_cheap = engine == "native"
        parallel = len(payloads) >= 4 and (
            ncpu >= 4 or (ncpu > 1 and not cells_are_cheap))

    n_family_launches = 0
    if parallel and payloads:
        if share_traces:
            _native.load()       # the workers' aggregation core, likewise
        workers = max_workers or min(ncpu, len(payloads))
        chunk = max(1, len(payloads) // (4 * workers))
        with concurrent.futures.ProcessPoolExecutor(
                workers, mp_context=pool_context()) as ex:
            for members, group_res in zip(
                    grp_members, ex.map(_run_group, payloads,
                                        chunksize=chunk)):
                scatter(members, group_res)
    elif engine in FAMILY_ENGINES and group_expansion:
        from repro_torch.core.warpsim import _cuda

        def read(launch, groups) -> None:
            raw = _cuda.collect(launch)
            with obs_mod.stage("scatter", family=launch.family,
                               units=len(raw)):
                i = 0
                for wl, stream, members in groups:
                    totals = stream_totals(stream)
                    scatter(members, [
                        loop_result(wl.name, cell[1], raw[i + j], totals)
                        for j, (cell, _key) in enumerate(members)])
                    i += len(members)

        # Family i+1's host stages run while family i's launch does;
        # family i is read after i+1 is launched, so at most two are in
        # flight. Payloads are family-major: a family is a run of them.
        pending = None
        start = 0
        for k in fam_sizes:
            groups = []
            pairs = []
            for payload, members in zip(payloads[start:start + k],
                                        grp_members[start:start + k]):
                wl, stream = _group_stream(payload, tcache, ecache)
                groups.append((wl, stream, members))
                pairs.extend((stream, cell[1]) for cell, _key in members)
            start += k
            wl = groups[0][0]
            launch = _cuda.launch_family(
                pairs, device, engine,
                family=f"{wl.name}/{wl.n_threads}/{wl.seed}")
            n_family_launches += 1
            if pending is not None:
                read(*pending)
            pending = (launch, groups)
        if pending is not None:
            read(*pending)
    else:
        for members, payload in zip(grp_members, payloads):
            scatter(members, _run_group(payload, trace_cache=tcache,
                                        expansion_cache=ecache,
                                        device=device))

    n_families = len(families)
    stats = dict(
        cells=len(cells),
        cache_hits=hits,
        cache_misses=len(todo) if cache is not None else 0,
        simulated=len(todo),
        peer_hits=0,
        expansion_groups=n_groups,
        expansions_saved=len(todo) - n_groups,
        trace_families=n_families,
        traces_shared=n_groups - n_families if share_traces else 0,
        family_launches=n_family_launches,
        expansion_cache_hits=ecache.hits - exp_hits0,
        expansion_cache_misses=ecache.misses - exp_miss0,
        trace_cache_hits=tcache.hits - trc_hits0,
        trace_cache_misses=tcache.misses - trc_miss0,
        trace_disk_hits=tcache.disk_hits - trc_disk0,
    )
    with _STATS_LOCK:
        _LAST_SWEEP_STATS.clear()
        _LAST_SWEEP_STATS.update(stats)
    ordered = {seed: {mname: {b: results[seed][mname][b]
                              for b in spec.benches}
                      for mname in mset}
               for seed in spec.seeds}
    if len(spec.seeds) == 1:
        return ordered[spec.seeds[0]], stats
    return ordered, stats
