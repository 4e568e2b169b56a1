"""Long-lived sweep result service over the port's cache stack.

The port's daemon: the reference's service (endpoints, wire forms,
counters, in-flight dedup, work queue, mesh, faults, observability),
computing each cell with the port's
:func:`~repro_torch.core.warpsim.sweep.compute_cell`, which is one
one-unit launch of the family kernel (K2, ``ws_family_kernel``) on the
card, or its plain version on the CPU when the daemon is started with
``--device cpu --engine torch``. Its records are bit for bit the
reference's, and its on-disk state is the reference's: the
:class:`~repro_torch.core.warpsim.sweep.ResultCache` files, the trace
snapshots and the queue-job snapshots under ``<cache root>/queue/``, so
a daemon of either package serves and adopts what the other wrote. It
serves:

* ``GET /cell?bench=BFS&machine=SW%2B[&seed=..&n_threads=..&field=..]`` —
  one grid cell. Machine is a suite name (``ws8``…, ``SW+``, ``LW+``) or
  any :class:`MachineConfig` assembled from query-param field overrides.
* ``POST /study`` — a typed :class:`~repro_torch.core.warpsim.api.Study`
  (JSON body ``{"study": study.to_dict()}``); returns the
  :class:`~repro_torch.core.warpsim.api.StudyResult` wire shape (flat
  records in the study's cell order + the run's private stats snapshot).
  The endpoint behind ``api.ServiceBackend``.
* ``POST /sweep`` — the legacy grid shape (JSON-encoded
  :class:`~repro_torch.core.warpsim.sweep.SweepSpec`); returns results in
  ``run_sweep``'s shape plus that run's private stats snapshot — a thin
  shim over the same :meth:`SweepService.study` core. With
  ``"enqueue": true`` the grid is instead sharded onto a lease-based
  :class:`~repro_torch.core.warpsim.work_queue.WorkQueue` for remote
  workers to drain (``/queue/lease`` / ``/queue/complete`` /
  ``/queue/status``). Queue job state is persisted under ``<cache
  root>/queue/`` — one JSON snapshot per job, atomically rewritten on
  every enqueue/lease/complete of that job, with job ids namespaced per
  daemon instance so daemons sharing a cache root never clobber each
  other's files — and reloaded on boot, so a daemon restart never
  forgets a half-drained sweep.
* ``GET /stats`` — service counters, live cache-stack counters (the
  result-cache entry count re-scans the directory via
  ``ResultCache.refresh()``, so cells written by sibling workers show
  up), queue status per job.
* ``GET /healthz`` — liveness, the daemon's engine (``cuda`` or
  ``torch``) and device, the aggregation core's status
  (:func:`repro_torch.core.warpsim._native.status`) and a ``cuda`` block
  (:func:`repro_torch.core.warpsim._cuda.status`: the kernel library's
  path and the launch counts of this process).
* ``GET /metrics`` (Prometheus text) and ``GET /debug/trace``.

A daemon asked for the card on a host without one refuses to start: it
never serves from the CPU in the card's place.

Daemons can federate into a **mesh** (:mod:`repro_torch.core.warpsim.mesh`)
over *disjoint* cache roots: ``WARPSIM_PEERS`` (plus
``WARPSIM_SELF_URL``, or ``--peers``/``--advertise-url``) names the
fleet, rendezvous hashing over the cell key assigns each cell an owner,
a local miss read-throughs to the owner (``GET /peer/cell``) before
simulating, completed cells are pushed to ``WARPSIM_REPLICATION``
members (``POST /peer/replicate``), and queue-job snapshots are
replicated/adopted across the fleet (``GET``/``POST /peer/job``) so a
worker survives its enqueuing daemon dying. Every peer interaction
degrades to local simulation (dead peer, partition, draining peer, key
skew) — the mesh buys durability and de-duplication, never correctness.

Requests for the *same uncomputed cell* are deduplicated in flight: the
first request simulates, every concurrent duplicate parks on the same
future and is served the one result (the ``dedup_waits`` counter counts
those). Results are deterministic, so deduplication is purely an
efficiency contract — but it is what makes a cold-start service behind
many clients cost one sweep instead of one per client.

The core simulates cell by cell, as the reference's does: a study of
N uncached cells makes N one-unit launches, where the in-process
``Session.run`` makes one launch per trace family.

Run the daemon (on the card; ``--device cpu --engine torch`` for the
plain versions)::

    PYTHONPATH=src python -m repro_torch.core.warpsim.service \
        --cache-dir benchmarks/results/torch/sweep_cache --port 8321

Point clients at it with ``WARPSIM_SERVICE_URL=http://127.0.0.1:8321``
(``repro_torch.benchmarks.figs`` picks it up via
``api.Session.from_env`` and falls back to in-process sweeps when unset
or dead).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import os
import random
import sys
import tempfile
import threading
import time
import uuid
import warnings
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple, Union
from urllib.parse import parse_qs, urlencode, urlparse

import torch

from repro_torch.core.warpsim import _cuda, _native
from repro_torch.core.warpsim import api as api_mod
from repro_torch.core.warpsim.api import (
    RunRecord, Session, Study, StudyResult,
)
from repro_torch.core.warpsim.config import MachineConfig
from repro_torch.core.warpsim import envcfg
from repro_torch.core.warpsim.faults import (
    Fault, FaultError, FaultPlan, ServiceError, ServiceUnavailable,
    fault_point,
)
from repro_torch.core.warpsim import mesh as mesh_mod
from repro_torch.core.warpsim import obs as obs_mod
from repro_torch.core.warpsim.mesh import MeshConfig
from repro_torch.core.warpsim.sweep import (
    MODEL_VERSION, SweepSpec, cell_key, compute_cell, family_major_cells,
    spec_from_dict, spec_to_dict,
)
from repro_torch.core.warpsim.timing import SimResult
from repro_torch.core.warpsim.trace import BENCHMARKS
from repro_torch.core.warpsim.work_queue import (
    WorkQueue, _http_json, cell_to_wire,
)

DEFAULT_CACHE_DIR = os.path.join("benchmarks", "results", "torch",
                                 "sweep_cache")
ENV_URL = "WARPSIM_SERVICE_URL"
ENV_URLS = "WARPSIM_SERVICE_URLS"
# Logical-operation id a ResilientClient stamps on every request; the
# daemon uses it as the fault-plan marker, so injected request faults fire
# once per *operation*, not once per retry attempt (retries must pass).
# The header also carries the trace context (``<op>;trace=<id>;span=<id>``)
# — the canonical constant and codec live in
# :mod:`repro_torch.core.warpsim.obs`; re-exported here.
OP_HEADER = obs_mod.OP_HEADER

# Legacy counter key -> (registry metric name, help). The keys are the
# exact shape ``stats()["counters"]`` has always had (plus the queue_*
# lease counters mirrored from each WorkQueue); the values now live in the
# daemon's metrics registry and surface verbatim at ``GET /metrics``.
# tests/test_obs.py asserts this table and the registry can't drift.
_COUNTER_METRICS = {  # guarded-by: frozen
    "requests": ("warpsim_http_requests_total",
                 "HTTP requests accepted (every route)"),
    "errors": ("warpsim_http_errors_total",
               "requests that ended in an error response"),
    "cells_served": ("warpsim_cells_served_total",
                     "cell lookups served (any source)"),
    "cache_hits": ("warpsim_cell_cache_hits_total",
                   "cells served from the result cache"),
    "simulated": ("warpsim_cells_simulated_total",
                  "cells simulated by this daemon"),
    "dedup_waits": ("warpsim_dedup_waits_total",
                    "requests parked on another request's in-flight cell"),
    "sweeps": ("warpsim_studies_total",
               "study/sweep bodies executed"),
    "sweep_cells": ("warpsim_study_cells_total",
                    "cells requested by study/sweep bodies"),
    "queue_cells_adopted": ("warpsim_queue_cells_adopted_total",
                            "worker-computed cells adopted via "
                            "/queue/complete"),
    "faults_injected": ("warpsim_faults_injected_total",
                        "injected faults fired by the daemon's plan"),
    "peer_forwards": ("warpsim_peer_forwards_total",
                      "outbound /peer/cell read-through attempts"),
    "peer_hits": ("warpsim_peer_hits_total",
                  "cells served by a mesh peer"),
    "peer_fallbacks": ("warpsim_peer_fallbacks_total",
                       "peer read-throughs that fell back to local sim"),
    "peer_serves": ("warpsim_peer_serves_total",
                    "inbound /peer/cell requests served"),
    "replicas_sent": ("warpsim_replicas_sent_total",
                      "cells pushed to replica successors"),
    "replica_send_failures": ("warpsim_replica_send_failures_total",
                              "replica pushes that failed (cells or jobs)"),
    "replicas_adopted": ("warpsim_replicas_adopted_total",
                         "cells adopted from /peer/replicate pushes"),
    "jobs_replicated": ("warpsim_jobs_replicated_total",
                        "queue-job snapshots pushed to peers"),
    "job_replicas_received": ("warpsim_job_replicas_received_total",
                              "peer job snapshots received"),
    "jobs_adopted_from_peers": ("warpsim_jobs_adopted_from_peers_total",
                                "jobs promoted from peer replicas"),
    "queue_leases_granted": ("warpsim_queue_leases_granted_total",
                             "work-queue chunk leases granted"),
    "queue_leases_expired": ("warpsim_queue_leases_expired_total",
                             "work-queue leases expired and requeued"),
    "queue_stale_completions": ("warpsim_queue_stale_completions_total",
                                "completions accepted from expired leases"),
}

# ResilientClient's legacy client_stats() counter keys, same contract.
_CLIENT_COUNTER_METRICS = {  # guarded-by: frozen
    "requests": ("warpsim_client_requests_total",
                 "logical client operations issued"),
    "attempts": ("warpsim_client_attempts_total",
                 "transport attempts (includes retries)"),
    "retries": ("warpsim_client_retries_total",
                "attempts beyond the first for one operation"),
    "failovers": ("warpsim_client_failovers_total",
                  "attempts that switched endpoint"),
    "breaker_opens": ("warpsim_client_breaker_opens_total",
                      "circuit breakers opened"),
    "breaker_closes": ("warpsim_client_breaker_closes_total",
                       "circuit breakers closed (probe or success)"),
    "probes": ("warpsim_client_probes_total",
               "healthz probes of cooling endpoints"),
    "exhausted": ("warpsim_client_exhausted_total",
                  "operations that ran out of retries/endpoints"),
}

_BOOL_TRUE = ("1", "true", "yes", "on")
_BOOL_FALSE = ("0", "false", "no", "off")


def _coerce(value: str, proto) -> object:
    """Parse a query-param string into the type of a MachineConfig field."""
    if isinstance(proto, bool):        # before int: bool is an int subclass
        v = value.lower()
        if v in _BOOL_TRUE:
            return True
        if v in _BOOL_FALSE:
            return False
        raise ValueError(f"bad boolean {value!r}")
    return type(proto)(value)


_CONFIG_PROTO = MachineConfig()
_CONFIG_FIELDS = {f.name: getattr(_CONFIG_PROTO, f.name)  # guarded-by: frozen
                  for f in dataclasses.fields(MachineConfig)}


def resolve_machine(params: Mapping[str, str]) -> MachineConfig:
    """Machine config from ``/cell`` query params.

    ``machine=`` names a preset (paper-suite name or ``ws<N>``); any
    :class:`MachineConfig` field given as a query param overrides the
    preset (or the default config when no preset is named), so arbitrary
    machine points are reachable without the POST body encoding. Field
    overrides without an explicit ``name=`` relabel the config
    ``"custom"`` — the preset's display name must not survive onto a
    machine it no longer describes (``machine=ws32&warp_size=64`` is not
    a ws32, and ``name`` participates in the cell cache key, so an honest
    label also keeps the keyspace honest).
    """
    simd = int(params.get("simd_width", 8))
    name = params.get("machine")
    base = (api_mod.resolve_machine_name(name, simd) if name
            else MachineConfig())
    overrides = {fname: _coerce(params[fname], proto)
                 for fname, proto in _CONFIG_FIELDS.items() if fname in params}
    if not overrides:
        return base
    if "name" not in overrides and set(overrides) - {"simd_width"}:
        overrides["name"] = "custom"
    return dataclasses.replace(base, **overrides)


# ---------------------------------------------------------------------------
# Service core (HTTP-free; the handler below is a thin codec over this)
# ---------------------------------------------------------------------------


class SweepService:
    """Shared state of the daemon: cache stack, in-flight dedup, queues.

    Thread-safe — every public method may be called from concurrent
    request threads. The in-flight table maps cell key -> Future: the
    first thread to miss both the cache and the table becomes the owner
    (simulates, publishes to the cache, resolves the future); every
    concurrent requester of the same key parks on ``Future.result()``.
    """

    def __init__(self, cache_dir: str, engine: str = "auto",
                 device="cuda",
                 persist_traces: bool = True, lease_seconds: float = 60.0,
                 clock=time.monotonic,
                 fault_plan: Optional[FaultPlan] = None,
                 mesh: Union[MeshConfig, None, bool] = None):
        # The daemon computes on one device: the card (each cell a
        # one-unit launch of the family kernel) unless the caller asks for
        # the CPU (the kernel's plain version). A daemon asked for the
        # card refuses to start without one, and loads its libraries
        # (building them when the tree has none) before it serves, so a
        # failed build fails the boot, never a request.
        self.device = torch.device(device)
        self.engine = _cuda.resolve_engine(engine, self.device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "the daemon was asked for device 'cuda', but no CUDA "
                    "device is available; start it on a card, or with "
                    "--device cpu --engine torch for the plain versions")
            _cuda.load()
        _native.load()
        # The daemon's cache stack is a Session: its own ResultCache plus
        # *instance* trace/expansion LRUs (a daemon embedded in a larger
        # process must not contend with that process's own sweeps on
        # recency order or counters).
        self.session = Session(device=self.device, cache_dir=cache_dir,
                               persist_traces=persist_traces)
        self.cache = self.session.result_cache
        self.trace_dir = self.session.trace_dir
        self.lease_seconds = lease_seconds
        # Injectable monotonic clock: drives every WorkQueue lease this
        # daemon owns, so tests exercise expiry/requeue deterministically.
        self._clock = clock
        # Chaos harness: a seeded FaultPlan (constructor arg, else
        # $WARPSIM_FAULTS, else none) consulted at the named fault points.
        self.fault_plan = (FaultPlan.from_env() if fault_plan is None
                           else fault_plan)
        self.dead = False       # a "kill" fault fired: play dead from now on
        self.draining = False   # /admin/drain: no new work, finish in-flight
        self.started = time.time()
        self._lock = threading.Lock()
        self._inflight: Dict[str, concurrent.futures.Future] = {}
        self._jobs: Dict[str, WorkQueue] = {}
        # Per-instance job-id namespace: ids are job-<daemon>-<seq>, so
        # two daemons over one cache root can never mint the same id (and
        # therefore never clobber each other's `<job>.json` snapshots —
        # the old `job-<seq>` scheme with a shared meta.json sequence did
        # exactly that). A restarted daemon gets a fresh namespace and
        # *adopts* the previous instance's jobs by their persisted names.
        self._daemon_id = uuid.uuid4().hex[:8]
        self._job_seq = 0
        self._queue_dir = os.path.join(cache_dir, "queue")
        self._persist_lock = threading.Lock()
        # Mesh federation: a MeshConfig wires this daemon into a peer fleet
        # — cell ownership by rendezvous hash, read-through forwarding,
        # N-way replication, cross-daemon queue-job visibility. `None`
        # (the default) reads $WARPSIM_PEERS/$WARPSIM_SELF_URL; `False`
        # disables the env path (the CLI uses it: the self URL isn't
        # known until after bind, see configure_mesh()).
        self.mesh: Optional[MeshConfig] = None
        if isinstance(mesh, MeshConfig):
            self.mesh = mesh
        elif mesh is None:
            self.mesh = MeshConfig.from_env()
        # Passive replicas of peers' queue-job snapshots (job id -> raw
        # WorkQueue.to_dict blob): held inert until this daemon is asked
        # about an unknown job, then promoted by _adopt_job.
        self._replica_jobs: Dict[str, dict] = {}
        # Observability domain of this daemon: the metrics registry behind
        # GET /metrics and the span ring behind GET /debug/trace, on the
        # same injectable clock as the lease machinery. The legacy
        # counters dict survives as a read-only view over the registry
        # (same keys, same integer reads) so /stats and every existing
        # assertion keep their shape while Prometheus scrapes the truth.
        self.obs = obs_mod.Observability(clock=clock)
        self.counters = obs_mod.CounterView(self.obs.registry,
                                            _COUNTER_METRICS)
        self._g_inflight = self.obs.registry.gauge(
            "warpsim_inflight_cells",
            "cells currently being simulated (in-flight dedup table size)")
        self._g_draining = self.obs.registry.gauge(
            "warpsim_draining",
            "1 while the daemon is draining (refusing new work)")
        self.last_sweep_stats: Dict[str, float] = {}
        self._load_jobs()

    def configure_mesh(self, mesh: Optional[MeshConfig]) -> None:
        """Join (or leave, with None) a peer mesh after construction.

        The CLI path: a daemon bound to an ephemeral port only knows its
        own peer-visible URL after ``serve()``, so it constructs with
        ``mesh=False`` and joins here.
        """
        self.mesh = mesh

    # -------------------------------------------------- queue persistence
    #
    # Layout under <cache root>/queue/: one `<job>.json` snapshot per job
    # (rewritten on enqueue/lease/complete of *that* job only — a lease
    # never pays for serializing its neighbors' cell payloads). Job ids
    # are `job-<daemon>-<seq>` with a per-instance daemon component, so
    # concurrent daemons over one cache root mint disjoint file names and
    # never clobber each other (they still cooperate on result *cells*
    # through index adoption; cross-daemon job *visibility* is the mesh's
    # job replication). Pre-namespace layouts are
    # still adopted on boot: legacy `job-<seq>.json` snapshots load by
    # their persisted names, and a legacy `meta.json` (the old shared
    # job-id sequence, no longer written) is tolerated and left alone —
    # fresh ids can't collide with either.

    _META = "meta.json"
    _REPLICA_PREFIX = "replica."

    def _job_path(self, job: str) -> str:
        return os.path.join(self._queue_dir, job + ".json")

    def _replica_path(self, job: str) -> str:
        return os.path.join(self._queue_dir,
                            self._REPLICA_PREFIX + job + ".json")

    def _load_jobs(self) -> None:
        """Re-adopt queue jobs persisted by a previous daemon over this
        cache root, so a restart doesn't forget half-drained sweeps
        (in-flight workers keep renewing/completing against the same job
        and chunk ids; lease clocks restart with their remaining time).

        *Corrupt* job files (bad JSON, wrong shape) are deleted and
        forgotten — the same degrade-to-cold contract as the result
        cache. *Unreadable* ones (transient EIO/EACCES, not corruption)
        are skipped but left on disk for the next boot to retry: a
        backup tool holding the file briefly must not destroy valid
        half-drained state. Job ids are adopted verbatim from the file
        names — legacy ``job-<seq>`` and namespaced ``job-<daemon>-<seq>``
        alike; neither can collide with this instance's fresh
        ``job-<daemon>-<seq>`` namespace, so no sequence floor needs
        recovering (the pre-namespace layout persisted one in
        ``meta.json``, which is skipped here and no longer written).
        """
        try:
            names = os.listdir(self._queue_dir)
        except OSError:
            return
        jobs: Dict[str, WorkQueue] = {}
        replicas: Dict[str, dict] = {}
        for name in sorted(names):
            if not name.endswith(".json") or name == self._META:
                continue
            path = os.path.join(self._queue_dir, name)
            if name.startswith(self._REPLICA_PREFIX):
                # A peer's job snapshot replicated to us: reload it as a
                # passive replica, not a live job — it only becomes live
                # if someone asks this daemon about it (_adopt_job).
                job = name[len(self._REPLICA_PREFIX):-len(".json")]
                try:
                    with open(path) as f:
                        blob = json.load(f)
                    if not isinstance(blob, dict):
                        raise ValueError("bad replica shape")
                    replicas[job] = blob
                except OSError:
                    continue                # transient: keep for next boot
                except Exception:
                    self._remove_file(path)
                continue
            job = name[:-len(".json")]
            try:
                with open(path) as f:
                    jobs[job] = WorkQueue.from_dict(json.load(f),
                                                    clock=self._clock,
                                                    on_count=self._queue_note)
            except OSError:
                continue                    # transient: keep for next boot
            except Exception:
                self._remove_file(path)
                continue
        with self._lock:
            self._jobs = jobs
            self._replica_jobs = {j: b for j, b in replicas.items()
                                  if j not in jobs}

    @staticmethod
    def _remove_file(path: str) -> None:
        try:
            os.remove(path)
        except OSError:
            pass

    def _atomic_write(self, path: str, blob: dict) -> None:
        data = json.dumps(blob).encode()
        tmp = None
        try:
            os.makedirs(self._queue_dir, exist_ok=True)
            fd, tmp = tempfile.mkstemp(
                dir=self._queue_dir,
                prefix=os.path.basename(path) + ".", suffix=".tmp")
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            os.replace(tmp, path)
        except OSError:
            if tmp is not None:
                self._remove_file(tmp)

    def _persist_job(self, job: str) -> None:
        """Atomically rewrite one job's snapshot (load-on-boot twin).

        Called after enqueue/lease/complete of that job. The persist lock
        spans snapshot *and* rename: two concurrent mutators of one job
        must publish in snapshot order, or the earlier writer's rename
        could land last and roll the on-disk state back past the later
        mutation. A mkstemp+rename publish means a crash mid-write leaves
        the previous complete snapshot, never a torn one.
        """
        with self._persist_lock:
            with self._lock:
                q = self._jobs.get(job)
            if q is None:
                self._remove_file(self._job_path(job))
                return
            blob = q.to_dict()
            self._atomic_write(self._job_path(job), blob)
        # Mesh: push the fresh snapshot to the job's replica successors
        # (outside the persist lock — a slow peer must not serialize
        # other jobs' persists). Every enqueue/lease/complete refreshes
        # the replicas, so a worker that loses this daemon finds the
        # job's latest persisted state on a sibling.
        self._replicate_job(job, blob)

    def bump(self, counter: str, n: int = 1) -> None:
        # The registry's own locks guard the increment — deliberately not
        # self._lock, so call sites already holding the service lock can
        # bump without a (non-reentrant) deadlock. Unknown names raise:
        # every counter must be declared in _COUNTER_METRICS.
        self.counters.inc(counter, n)

    def _queue_note(self, counter: str) -> None:
        # WorkQueue lease-counter hook: mirror each increment into the
        # registry (the queues keep their own ints for persistence).
        self.counters.inc("queue_" + counter)

    # ---------------------------------------------------- faults / drain

    def check_fault(self, point: str,
                    marker: Optional[str] = None) -> Optional[Fault]:
        """Consult the daemon's fault plan (no-op when none is loaded)."""
        if self.fault_plan is None:
            return None
        fault = self.fault_plan.check(point, marker)
        if fault is not None:
            self.bump("faults_injected")
        return fault

    def kill(self) -> None:
        """Play dead: every subsequent connection is closed unanswered,
        indistinguishable (to clients) from a SIGKILLed process."""
        self.dead = True

    def drain(self, wait_seconds: float = 10.0) -> dict:
        """Graceful-shutdown path (``POST /admin/drain``).

        Flips the daemon into draining mode: ``/queue/lease`` stops
        granting chunks (in-flight leases may still renew and complete —
        workers finish what they hold), new ``/cell``/``/study``/``/sweep``
        work is refused with 503 (a ResilientClient fails over to a
        sibling), in-flight cell simulations are given up to
        `wait_seconds` to finish, and every queue job's state is
        persisted. After this returns the process can be stopped without
        stranding anything.
        """
        with self._lock:
            self.draining = True
            jobs = list(self._jobs)
        self._g_draining.set(1)
        deadline = time.monotonic() + wait_seconds
        while time.monotonic() < deadline:
            with self._lock:
                if not self._inflight:
                    break
            time.sleep(0.01)
        for job in jobs:
            self._persist_job(job)
        with self._lock:
            in_flight = len(self._inflight)
        return {"ok": True, "draining": True,
                "jobs_persisted": len(jobs), "in_flight": in_flight}

    # ------------------------------------------------------------- cells

    def _note_cell(self, key: str, source: str) -> None:
        # Trace event per cell decision: /debug/trace answers "which
        # daemon simulated / cached / peer-served this cell" directly.
        obs_mod.event("cell", key=key[:12], source=source)

    def cell(self, bench: str, cfg: MachineConfig,
             n_threads: Optional[int] = None, seed: int = 0,
             engine: Optional[str] = None) -> SimResult:
        return self.cell_with_source(bench, cfg, n_threads, seed, engine)[0]

    def cell_with_source(self, bench: str, cfg: MachineConfig,
                         n_threads: Optional[int] = None, seed: int = 0,
                         engine: Optional[str] = None,
                         forwarded: bool = False
                         ) -> Tuple[SimResult, str]:
        """One cell plus how it was served:
        "cache" | "simulated" | "dedup" | "peer".

        With a mesh configured, a local miss on a cell this daemon does
        not own first read-throughs to the owner (then the replica
        successors) before simulating; any peer failure degrades to
        local simulation. `forwarded` marks a request that *arrived*
        over ``GET /peer/cell`` — it must never forward again (the
        owner simulates; rankings agree fleet-wide, so a second hop
        could only mean membership skew, and a one-hop bound keeps even
        that converging instead of cycling).
        """
        key = cell_key(bench, cfg, n_threads, seed)
        with obs_mod.stage("cache_get", key=key[:12]):
            res = self.cache.get(key)   # optimistic: no service lock held
        if res is not None:
            self.bump("cells_served")
            self.bump("cache_hits")
            self._note_cell(key, "cache")
            return res, "cache"
        owner = False
        with self._lock:
            self.bump("cells_served")
            fut = self._inflight.get(key)
            if fut is None:
                # Re-probe under the lock: the owner of a just-finished
                # in-flight simulation published to the cache and left the
                # table between our optimistic probe and here. contains()
                # first — it skips the hit/miss counters, so the common
                # cold path doesn't double-count the optimistic miss.
                res = self.cache.get(key) if self.cache.contains(key) else None
                if res is not None:
                    self.bump("cache_hits")
                    self._note_cell(key, "cache")
                    return res, "cache"
                fut = concurrent.futures.Future()
                self._inflight[key] = fut
                self._g_inflight.set(len(self._inflight))
                owner = True
            else:
                self.bump("dedup_waits")
        if not owner:
            res = fut.result()
            self._note_cell(key, "dedup")
            return res, "dedup"
        source = "simulated"
        try:
            res = None
            if not forwarded:
                res = self._peer_fetch(key, bench, cfg, n_threads, seed)
                if res is not None:
                    source = "peer"
            if res is None:
                res = compute_cell(bench, cfg, n_threads=n_threads,
                                   seed=seed, engine=engine or self.engine,
                                   device=self.device,
                                   trace_dir=self.trace_dir,
                                   trace_cache=self.session.trace_cache,
                                   expansion_cache=self.session.expansion_cache)
            with obs_mod.stage("cache_put", key=key[:12]):
                self.cache.put(key, res)
            if source == "simulated":
                self.bump("simulated")
            fut.set_result(res)
        except BaseException as e:
            fut.set_exception(e)
            raise
        finally:
            with self._lock:
                self._inflight.pop(key, None)
                self._g_inflight.set(len(self._inflight))
        self._note_cell(key, source)
        if source == "simulated":
            # Mesh durability: push the fresh cell to its replica
            # successors BEFORE the kill-fault hook below — a daemon
            # killed right after computing a cell must not take the
            # fleet's only copy down with its disk.
            self._replicate_cells([(key, res)])
            # Chaos hook: "daemon dies after N cells". Checked strictly
            # AFTER the result is cached, replicated, and the dedup
            # future resolved — a killed daemon's completed cells stay
            # reachable (shared root or replicas), which is what makes
            # failover re-simulate (almost) nothing.
            fault = self.check_fault(fault_point("service.cell"), marker=key)
            if fault is not None:
                if fault.action == "kill":
                    self.kill()
                raise FaultError(
                    f"injected {fault.action} at service.cell ({key[:12]}…)")
        return res, source

    # -------------------------------------------------------------- mesh

    def _peer_fetch(self, key: str, bench: str, cfg: MachineConfig,
                    n_threads: Optional[int], seed: int
                    ) -> Optional[SimResult]:
        """Read-through to the cell's owner (then replicas) on a local
        miss; None when this daemon should simulate itself.

        The owner is asked with ``simulate=1`` (it computes on a miss —
        that is the point of ownership: one designated simulator per
        cell fleet-wide, so concurrent misses across daemons collapse
        onto its in-flight dedup table). Replica successors are asked
        cache-only (``simulate=0``): if the owner is down, a replica
        *serving* a copy is a win, but a replica *simulating* would race
        other members doing the same. Every failure — dead peer,
        draining 503, key-version skew, injected ``peer.forward`` fault
        — falls through to the next candidate, then to local simulation
        (the partition degrade: correctness never depends on the mesh).
        """
        mesh = self.mesh
        if mesh is None:
            return None
        order = mesh.fetch_order(key)
        if not order:
            return None                     # we own it: simulate locally
        params = {f.name: str(getattr(cfg, f.name))
                  for f in dataclasses.fields(MachineConfig)}
        params.update(bench=bench, seed=str(seed), key=key)
        if n_threads is not None:
            params["n_threads"] = str(n_threads)
        for rank, target in enumerate(order):
            self.bump("peer_forwards")
            fault = self.check_fault(fault_point("peer.forward"),
                                     marker=f"{key}@{target}")
            if fault is not None:
                continue                    # injected: peer unreachable
            params["simulate"] = "1" if rank == 0 else "0"
            try:
                # The trace headers carry the study's trace id to the
                # peer: its server span for this /peer/cell chains to
                # ours, so cross-daemon hops reconstruct from the dumps.
                with obs_mod.stage("peer_forward", target=target, rank=rank):
                    resp = _http_json(
                        target + "/peer/cell?" + urlencode(params),
                        timeout=mesh.peer_timeout,
                        headers=obs_mod.trace_headers())
            except ServiceError:
                continue
            if resp.get("found"):
                self.bump("peer_hits")
                return SimResult(**resp["result"])
        self.bump("peer_fallbacks")
        return None

    def peer_cell(self, params: Mapping[str, str]) -> dict:
        """Serve ``GET /peer/cell``: a peer's read-through request.

        The requester sends every MachineConfig field plus its computed
        cell key; we recompute the key and reject on mismatch (400) —
        the one way two daemons disagree on a key is MODEL_VERSION or
        field-set skew across a rolling upgrade, and serving a result
        under the wrong key would poison the requester's cache.
        ``simulate=0`` (replica rank) answers from cache only;
        ``simulate=1`` (owner rank) runs the full cell path — including
        its own in-flight dedup, so concurrent forwards collapse.
        """
        bench = params["bench"]
        cfg = resolve_machine(params)
        n_threads = (int(params["n_threads"])
                     if "n_threads" in params else None)
        seed = int(params.get("seed", 0))
        key = cell_key(bench, cfg, n_threads, seed)
        claimed = params.get("key")
        if claimed and claimed != key:
            raise ValueError(
                f"peer cell-key mismatch (model/version skew?): "
                f"ours {key[:12]}… theirs {claimed[:12]}…")
        self.bump("peer_serves")
        if params.get("simulate", "1").lower() in _BOOL_FALSE:
            res = self.cache.get(key)
            if res is None:
                return {"found": False, "key": key}
        else:
            res, _src = self.cell_with_source(bench, cfg, n_threads, seed,
                                              forwarded=True)
        return {"found": True, "key": key,
                "result": dataclasses.asdict(res)}

    def _replicate_cells(self, items: Sequence[Tuple[str, SimResult]]
                         ) -> None:
        """Push completed cells to their replica successors (one batched
        ``POST /peer/replicate`` per target). Best-effort: a failed push
        is counted and dropped — the cell is still in our cache, and a
        reader that misses the lost replica degrades to a forward or a
        local re-simulation."""
        mesh = self.mesh
        if mesh is None or not items:
            return
        by_target: Dict[str, List[dict]] = {}
        for key, res in items:
            for target in mesh.replica_targets(key):
                fault = self.check_fault(fault_point("peer.replicate"),
                                         marker=f"{key}@{target}")
                if fault is not None:
                    self.bump("replica_send_failures")
                    continue
                by_target.setdefault(target, []).append(
                    {"key": key, "result": dataclasses.asdict(res)})
        for target, cells in by_target.items():
            try:
                with obs_mod.stage("replicate", target=target,
                                   cells=len(cells)):
                    _http_json(target + "/peer/replicate", {"cells": cells},
                               timeout=mesh.peer_timeout,
                               headers=obs_mod.trace_headers())
            except ServiceError:
                self.bump("replica_send_failures", len(cells))
            else:
                self.bump("replicas_sent", len(cells))

    def adopt_cell_replicas(self, cells: Iterable[Mapping]) -> int:
        """Serve ``POST /peer/replicate``: store a peer's pushed cells."""
        n = 0
        for ent in cells:
            try:
                key, res = ent["key"], SimResult(**ent["result"])
            except (KeyError, TypeError) as e:
                raise ValueError(f"bad replica payload: {e}") from e
            self.cache.put(key, res)
            n += 1
        if n:
            self.bump("replicas_adopted", n)
        return n

    def _replicate_job(self, job: str, blob: dict) -> None:
        """Push one job snapshot to its replica successors (best-effort,
        called after every persist of that job)."""
        mesh = self.mesh
        if mesh is None:
            return
        sent = 0
        for target in mesh.job_targets(job):
            fault = self.check_fault(fault_point("peer.replicate"),
                                     marker=f"job:{job}@{target}")
            if fault is not None:
                self.bump("replica_send_failures")
                continue
            try:
                with obs_mod.stage("replicate", target=target, job=job):
                    _http_json(target + "/peer/job",
                               {"job": job, "queue": blob},
                               timeout=mesh.peer_timeout,
                               headers=obs_mod.trace_headers())
            except ServiceError:
                self.bump("replica_send_failures")
            else:
                sent += 1
        if sent:
            self.bump("jobs_replicated")

    # Passive job replicas held before the oldest are dropped — same
    # bounded-daemon principle as MAX_JOBS.
    MAX_REPLICA_JOBS = 128

    def adopt_job_replica(self, job: str, blob: Mapping) -> None:
        """Serve ``POST /peer/job``: hold a peer's job snapshot, inert,
        until someone asks this daemon about that job (_adopt_job)."""
        if not isinstance(blob, Mapping) or "chunks" not in blob:
            raise ValueError(f"bad job replica for {job!r}")
        with self._lock:
            if job in self._jobs:
                return      # we already own it live: replica is stale
            self._replica_jobs[job] = dict(blob)
            stale = list(self._replica_jobs)
            for j in stale[:max(0, len(stale) - self.MAX_REPLICA_JOBS)]:
                del self._replica_jobs[j]
                self._remove_file(self._replica_path(j))
        self.bump("job_replicas_received")
        with self._persist_lock:
            self._atomic_write(self._replica_path(job), dict(blob))

    def _adopt_job(self, job: str) -> Optional[WorkQueue]:
        """Promote an unknown job from the replica table — or from a
        peer's live/replica tables (``GET /peer/job``) — into this
        daemon's live jobs.

        The cross-daemon visibility contract: a worker or status poller
        pointed at *any* mesh member finds the job. Lease clocks restart
        from the snapshot's remaining time (same degrade as a daemon
        restart). If the original owner is still alive both daemons may
        briefly lease chunks independently — completes are idempotent
        and cells deterministic, so the cost is bounded duplicate work,
        never wrong records.
        """
        with self._lock:
            blob = self._replica_jobs.pop(job, None)
        mesh = self.mesh
        if blob is None and mesh is not None:
            for target in mesh.peers:
                fault = self.check_fault(fault_point("peer.forward"),
                                         marker=f"job:{job}@{target}")
                if fault is not None:
                    continue
                try:
                    resp = _http_json(
                        target + "/peer/job?" + urlencode({"job": job}),
                        timeout=mesh.peer_timeout)
                except ServiceError:
                    continue
                if resp.get("found"):
                    blob = resp["queue"]
                    break
        if blob is None:
            return None
        try:
            q = WorkQueue.from_dict(blob, clock=self._clock,
                                    on_count=self._queue_note)
        except Exception as e:      # noqa: BLE001 — corrupt replica
            raise ValueError(f"unusable job replica for {job!r}: "
                             f"{e.__class__.__name__}: {e}") from e
        with self._lock:
            live = self._jobs.get(job)
            if live is not None:
                return live         # lost the adoption race: use theirs
            self._jobs[job] = q
        self._remove_file(self._replica_path(job))
        self.bump("jobs_adopted_from_peers")
        self._persist_job(job)
        return q

    # ------------------------------------------------------------ sweeps

    def study(self, study: Study) -> StudyResult:
        """Serve a whole :class:`~repro_torch.core.warpsim.api.Study`.

        The facade core of the daemon (``POST /study``; the legacy
        ``POST /sweep`` shape is a shim over it). Cells run through
        :meth:`cell_with_source` in family-major order, so uncached runs
        get the sweep engine's trace/expansion sharing through the
        session-owned LRUs, and every cell dedups against concurrent
        ``/cell`` and ``/sweep``/``/study`` requests. Trace families are
        fanned across a small thread pool (one family per task keeps its
        cells' trace/stream locality) so a cold grid uses the host's
        cores — the aggregation core and the kernel launch release the
        GIL inside their C calls, and the cache stack and the kernel
        libraries' loaders and counters are lock-guarded, so threads are
        both safe and effective here. Each simulated cell is one one-unit
        launch on the daemon's device. The result's `stats` mirrors
        ``run_sweep_with_stats``'s snapshot keys (plus ``dedup_waits``).
        """
        t0 = time.time()
        engine = (None if study.engine in (None, "auto", "")
                  else study.engine)
        spec = study.to_spec()
        mset = spec.machine_set()
        cells = family_major_cells(spec.cells(machine_set=mset))
        ecache = self.session.expansion_cache
        tcache = self.session.trace_cache
        exp0 = (ecache.hits, ecache.misses)
        trc0 = (tcache.hits, tcache.misses, tcache.disk_hits)
        by_cell: Dict[tuple, SimResult] = {}
        counts = {"cache": 0, "simulated": 0, "dedup": 0, "peer": 0}
        sim_groups, sim_families = set(), set()

        families: List[List] = []
        for cell in cells:              # consecutive runs share a family
            fam = (cell[2], cell[3], cell[4])
            if not families or fam != families[-1][0]:
                families.append([fam, []])
            families[-1][1].append(cell)

        # Pool threads don't inherit contextvars: capture the request's
        # trace context here and re-activate it per family task, so every
        # cell/stage/peer-hop span of a fanned-out study stays in the one
        # trace its HTTP server span started.
        ctx = obs_mod.current()

        def run_family(group):
            out = []
            with obs_mod.activate(ctx):
                for mname, cfg, bench, n_threads, seed in group:
                    out.append(((mname, cfg, bench, n_threads, seed),
                                self.cell_with_source(bench, cfg, n_threads,
                                                      seed, engine=engine)))
            return out

        workers = min(8, os.cpu_count() or 1, len(families)) or 1
        if workers > 1:
            with concurrent.futures.ThreadPoolExecutor(workers) as pool:
                per_family = pool.map(run_family,
                                      (g for _, g in families))
                done = [cell for fam in per_family for cell in fam]
        else:
            done = [cell for _, g in families for cell in run_family(g)]

        for (mname, cfg, bench, n_threads, seed), (res, src) in done:
            counts[src] += 1
            if src not in ("cache", "peer"):
                # Peer-served cells were never expanded locally — they
                # must not inflate the expansion/trace sharing stats.
                fam = (bench, n_threads, seed)
                sim_families.add(fam)
                sim_groups.add(fam + (cfg.expansion_key(),))
            by_cell[(mname, bench, seed)] = res
        uncached = counts["simulated"] + counts["dedup"]
        stats = dict(
            cells=len(cells),
            cache_hits=counts["cache"],
            cache_misses=uncached + counts["peer"],
            simulated=counts["simulated"],
            peer_hits=counts["peer"],
            dedup_waits=counts["dedup"],
            expansion_groups=len(sim_groups),
            expansions_saved=uncached - len(sim_groups),
            trace_families=len(sim_families),
            traces_shared=len(sim_groups) - len(sim_families),
            expansion_cache_hits=ecache.hits - exp0[0],
            expansion_cache_misses=ecache.misses - exp0[1],
            trace_cache_hits=tcache.hits - trc0[0],
            trace_cache_misses=tcache.misses - trc0[1],
            trace_disk_hits=tcache.disk_hits - trc0[2],
            elapsed_s=round(time.time() - t0, 6),
        )
        self.bump("sweeps")
        self.bump("sweep_cells", len(cells))
        with self._lock:
            self.last_sweep_stats = stats
        # Records in the study's fixed cell order, independent of the
        # family-major execution order above.
        records = tuple(
            RunRecord(machine=mname, bench=bench, seed=seed,
                      n_threads=n_threads,
                      result=by_cell[(mname, bench, seed)])
            for mname, _cfg, bench, n_threads, seed
            in spec.cells(machine_set=mset))
        return StudyResult(records=records, stats=stats, backend="service")

    def sweep(self, spec: SweepSpec,
              engine: Optional[str] = None) -> Tuple[Dict, Dict]:
        """Deprecated shim over :meth:`study` for the legacy ``POST
        /sweep`` shape: ``(run_sweep-shaped results, stats)``."""
        res = self.study(Study.from_spec(spec, engine=engine or "auto"))
        return res.legacy_grid(), res.stats

    # ------------------------------------------------------------- queue

    # Finished jobs kept queryable (status polling) before the oldest are
    # dropped, and a hard ceiling on jobs of *any* state so abandoned
    # enqueues (workers never showed up) can't grow the daemon without
    # bound either — evicting oldest-first in both passes (dict order).
    MAX_FINISHED_JOBS = 32
    MAX_JOBS = 128

    def enqueue(self, spec: SweepSpec, chunk_size: int = 16,
                lease_seconds: Optional[float] = None) -> dict:
        """Shard a grid's *uncached* cells onto a new lease-based job."""
        todo = [c for c in family_major_cells(spec.cells())
                if not self.cache.contains(cell_key(c[2], c[1], c[3], c[4]))]
        # Stamp the enqueuing study's trace id onto the job: it persists
        # with the snapshot and rides every lease response, so worker
        # hops (possibly on other hosts, days later) join the same trace.
        ctx = obs_mod.current()
        q = WorkQueue(todo, chunk_size=chunk_size,
                      lease_seconds=lease_seconds or self.lease_seconds,
                      clock=self._clock,
                      trace_id=(ctx.trace_id or None) if ctx else None,
                      on_count=self._queue_note)
        evicted = []
        with self._lock:
            self._job_seq += 1
            job = f"job-{self._daemon_id}-{self._job_seq}"
            self._jobs[job] = q
            finished = [j for j, jq in self._jobs.items()
                        if jq is not q and jq.done]
            for j in finished[:max(0, len(finished)
                                   - self.MAX_FINISHED_JOBS)]:
                del self._jobs[j]
                evicted.append(j)
            stale = [j for j, jq in self._jobs.items() if jq is not q]
            for j in stale[:max(0, len(self._jobs) - self.MAX_JOBS)]:
                del self._jobs[j]       # abandoned jobs: oldest first
                evicted.append(j)
        self._persist_job(job)
        for j in evicted:
            self._persist_job(j)        # job gone -> snapshot removed
        return {"job": job, **q.status()}

    def _job(self, job: str) -> WorkQueue:
        with self._lock:
            q = self._jobs.get(job)
        if q is None:
            # Mesh: a job another daemon minted may live here as a
            # passive replica, or on a peer — adopt before giving up.
            q = self._adopt_job(job)
        if q is None:
            raise ValueError(f"unknown job {job!r}")
        return q

    def queue_lease(self, job: str, worker: str) -> dict:
        q = self._job(job)
        if self.draining:
            # Rolling restart: stop handing out work; workers holding
            # leases may still renew/complete, everyone else sees "no
            # chunk" and polls a sibling (or waits out the restart).
            return {"job": job, "chunk": None, "done": q.done,
                    "draining": True}
        chunk = q.lease(worker)
        if chunk is None:
            return {"job": job, "chunk": None, "done": q.done}
        self._persist_job(job)
        # "trace"/"trace_span": the job's trace id plus THIS grant's
        # server span, so a worker (maybe another process entirely) can
        # parent its chunk span to the lease hop that handed it the work.
        ctx = obs_mod.current()
        return {"job": job, "chunk": chunk.chunk_id,
                "cells": [cell_to_wire(c) for c in chunk.cells],
                "lease_seconds": q.lease_seconds, "done": False,
                "trace": q.trace_id,
                "trace_span": (ctx.span_id or None) if ctx else None}

    def queue_renew(self, job: str, chunk: int, worker: str) -> dict:
        # Deliberately not persisted: workers renew between every cell, so
        # persisting here would rewrite the whole table O(cells) times per
        # worker for no correctness gain — an unpersisted renewal only
        # means the lease restarts with less remaining time after a daemon
        # restart and the chunk requeues sooner (the documented safe
        # degrade; completions are idempotent and stale-tolerant).
        return {"ok": self._job(job).renew(int(chunk), worker),
                "job": job, "chunk": int(chunk)}

    def queue_complete(self, job: str, chunk: int, worker: str,
                       results: Iterable[Mapping]) -> dict:
        """Adopt a worker's results into the cache and retire its chunk.

        Workers POST result fields back instead of relying on a shared
        filesystem, so a queue can span hosts whose only common ground is
        this service. (Results are deterministic and content-addressed;
        adopting a duplicate is byte-identical.)
        """
        q = self._job(job)
        n = 0
        adopted: List[Tuple[str, SimResult]] = []
        for ent in results:
            res = SimResult(**ent["result"])
            self.cache.put(ent["key"], res)
            adopted.append((ent["key"], res))
            n += 1
        if n:
            self.bump("queue_cells_adopted", n)
            # Worker-computed cells get the same durability as locally
            # simulated ones: replicate to their successors.
            self._replicate_cells(adopted)
        ok = q.complete(int(chunk), worker)
        self._persist_job(job)
        return {"ok": ok, "job": job, "chunk": int(chunk), "done": q.done}

    def queue_status(self, job: str) -> dict:
        return {"job": job, **self._job(job).status()}

    # ------------------------------------------------------ observability

    _MESH_COUNTERS = (
        "peer_forwards", "peer_hits", "peer_fallbacks", "peer_serves",
        "replicas_sent", "replica_send_failures", "replicas_adopted",
        "jobs_replicated", "job_replicas_received",
        "jobs_adopted_from_peers",
    )

    def mesh_stats(self) -> dict:
        """Mesh state for ``/stats``/``/healthz``: membership + the
        forward/replication counters (``{"enabled": False}`` when this
        daemon is not federated)."""
        if self.mesh is None:
            return {"enabled": False}
        with self._lock:
            snap = {k: self.counters.get(k, 0)
                    for k in self._MESH_COUNTERS}
            held = len(self._replica_jobs)
        return {"enabled": True, **self.mesh.describe(),
                "job_replicas_held": held, **snap}

    def healthz(self) -> dict:
        """Liveness, the engine and device every cell of this daemon runs
        on, and the status of its two libraries: the aggregation core
        (``native``) and the family kernel (``cuda``: the loaded
        library's path and this process's launch counts; on a CPU
        daemon, no library and no launch)."""
        return {
            "ok": True,
            "model": MODEL_VERSION,
            "engine": self.engine,
            "device": str(self.device),
            "native": _native.status(),
            "cuda": _cuda.status(),
            "draining": self.draining,
            "cache_root": os.path.abspath(self.cache.root),
            "mesh": ({"enabled": True, **self.mesh.describe()}
                     if self.mesh is not None else {"enabled": False}),
            "uptime_s": round(time.time() - self.started, 3),
        }

    def stats(self) -> dict:
        with self._lock:
            counters = dict(self.counters)
            in_flight = len(self._inflight)
            jobs = {job: q.status() for job, q in self._jobs.items()}
            last_sweep = dict(self.last_sweep_stats)
        return {
            "counters": counters,
            "in_flight": in_flight,
            "draining": self.draining,
            "faults": (self.fault_plan.stats()
                       if self.fault_plan is not None else None),
            "result_cache": {
                # refresh() re-scans the directory, so entries written by
                # sibling workers/processes since startup are counted.
                "entries": self.cache.refresh(),
                "hits": self.cache.hits,
                "misses": self.cache.misses,
                "adopted": self.cache.adopted,
                "corrupt": self.cache.corrupt,
            },
            "expansion_cache": {
                "size": len(self.session.expansion_cache),
                "hits": self.session.expansion_cache.hits,
                "misses": self.session.expansion_cache.misses,
            },
            "trace_cache": {
                "size": len(self.session.trace_cache),
                "hits": self.session.trace_cache.hits,
                "misses": self.session.trace_cache.misses,
                "disk_hits": self.session.trace_cache.disk_hits,
                "builds": self.session.trace_cache.builds,
            },
            "jobs": jobs,
            "mesh": self.mesh_stats(),
            "obs": self.obs.describe(),
            "last_sweep": last_sweep,
            "uptime_s": round(time.time() - self.started, 3),
        }


# ---------------------------------------------------------------------------
# HTTP layer
# ---------------------------------------------------------------------------


def _encode_results(results: Dict, seeds: Tuple[int, ...]) -> Dict:
    def _machines(per_m: Dict) -> Dict:
        return {m: {b: dataclasses.asdict(r) for b, r in per_b.items()}
                for m, per_b in per_m.items()}
    if len(seeds) == 1:
        return _machines(results)
    return {str(seed): _machines(per_m) for seed, per_m in results.items()}


def _decode_results(blob: Dict, seeds: List[int]) -> Dict:
    def _machines(per_m: Dict) -> Dict:
        return {m: {b: SimResult(**fields) for b, fields in per_b.items()}
                for m, per_b in per_m.items()}
    if len(seeds) == 1:
        return _machines(blob)
    return {int(seed): _machines(per_m) for seed, per_m in blob.items()}


class SweepRequestHandler(BaseHTTPRequestHandler):
    """Thin JSON codec over :class:`SweepService` (set as a class attr)."""

    service: SweepService
    quiet = True
    protocol_version = "HTTP/1.1"   # keep-alive (Content-Length always set)
    server_version = "warpsim-sweep/1"

    def log_message(self, fmt, *args):  # noqa: D102 — stdlib signature
        if not self.quiet:
            BaseHTTPRequestHandler.log_message(self, fmt, *args)

    def _send(self, obj, code: int = 200) -> None:
        if getattr(self, "_drop_response", False) and code == 200:
            # Injected `response/<path>:drop`: the handler did its work
            # (state mutated server-side) but the ack is lost on the
            # floor — the client sees a closed connection and must treat
            # the operation as "maybe happened" (idempotency proof).
            self.close_connection = True
            return
        data = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _send_text(self, text: str, code: int = 200,
                   content_type: str =
                   "text/plain; version=0.0.4; charset=utf-8") -> None:
        """Plain-text twin of :meth:`_send` (the Prometheus exposition
        content type is the stated default)."""
        if getattr(self, "_drop_response", False) and code == 200:
            self.close_connection = True
            return
        data = text.encode()
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _try_send(self, obj, code: int) -> None:
        try:
            self._send(obj, code)
        except OSError:
            pass                         # socket already dead/half-written

    def _drop(self) -> None:
        # Close without writing any response: with keep-alive HTTP/1.1
        # the server tears the socket down right after the handler
        # returns, so the client gets RemoteDisconnected immediately —
        # exactly what a SIGKILLed daemon looks like.
        self.close_connection = True

    def _route(self, fn) -> None:
        svc = self.service
        if svc.dead:
            self._drop()
            return
        path = urlparse(self.path).path
        # Marker for request-level fault rules: the logical-operation id a
        # ResilientClient stamps on the request (so its *retries* of one
        # op pass), else method+path (so a plain client's identical retry
        # of a GET also passes — the path including the query IS the op).
        # The same header may carry the caller's trace context; only the
        # op portion is the fault marker, so markers — and therefore
        # marker-keyed fault schedules — are identical with and without
        # tracing, and stable across the retries of one operation.
        op, tid, sid = obs_mod.parse_op_header(self.headers.get(OP_HEADER))
        marker = op or f"{self.command} {self.path}"
        self._drop_response = False
        # Everything below — fault checks included — runs inside this
        # request's server span: injected faults land as events in the
        # caller's trace, and a retried op shows one attempt span chain.
        # Untraced (legacy-client) requests still bind this daemon's
        # domain, so stage histograms always land in ITS /metrics.
        joined = (obs_mod.join_trace(tid, "server" + path, obs=svc.obs,
                                     parent=sid, method=self.command)
                  if tid else obs_mod.bind(svc.obs))
        with joined:
            fault = svc.check_fault(fault_point("server" + path), marker)
            if fault is not None:
                if fault.action == "kill":
                    svc.kill()
                    self._drop()
                    return
                if fault.action in ("drop", "corrupt"):
                    self._drop()
                    return
                if fault.action == "error":
                    self._try_send(
                        {"error": f"injected fault at server{path}"},
                        fault.code)
                    return
                if fault.action == "delay":
                    time.sleep(fault.delay_s)
            resp_fault = svc.check_fault(fault_point("response" + path),
                                         marker)
            if resp_fault is not None and resp_fault.action == "drop":
                self._drop_response = True
            # A draining daemon refuses new simulation work — including a
            # peer's read-through (the requester's degrade path simulates
            # locally). /peer/replicate and /peer/job stay open: accepting
            # a sibling's replicas is cheap and loses nothing on shutdown.
            if svc.draining and path in ("/cell", "/study", "/sweep",
                                         "/peer/cell"):
                svc.bump("requests")
                self._try_send(
                    {"error": "draining: not accepting new work"}, 503)
                return
            svc.bump("requests")
            try:
                fn()
            except (KeyError, ValueError) as e:
                svc.bump("errors")
                self._try_send({"error": f"{e.__class__.__name__}: {e}"},
                               400)
            except ConnectionError:
                pass         # client went away mid-response (reset or pipe)
            except FaultError as e:
                # An injected fault fired mid-handling. A kill means the
                # daemon is now dead: drop the connection like the real
                # thing. Anything else reports as a server error.
                if svc.dead:
                    self._drop()
                    return
                svc.bump("errors")
                self._try_send({"error": f"{e.__class__.__name__}: {e}"},
                               500)
            except Exception as e:       # noqa: BLE001 — report, don't die
                svc.bump("errors")
                self._try_send({"error": f"{e.__class__.__name__}: {e}"},
                               500)

    def do_GET(self):  # noqa: N802 — stdlib naming
        path = urlparse(self.path).path
        params = {k: v[-1]
                  for k, v in parse_qs(urlparse(self.path).query).items()}
        svc = self.service

        def handle():
            if path == "/healthz":
                self._send(svc.healthz())
            elif path == "/stats":
                self._send(svc.stats())
            elif path == "/metrics":
                # Prometheus text exposition over the daemon's registry —
                # the same counters /stats serves as the legacy dict.
                self._send_text(svc.obs.registry.render())
            elif path == "/debug/trace":
                tid = params.get("id")
                if tid:
                    self._send({"trace": tid,
                                "spans": svc.obs.spans.dump(tid)})
                else:
                    self._send({"traces": svc.obs.spans.traces(),
                                **svc.obs.describe()})
            elif path == "/cell":
                bench = params["bench"]
                cfg = resolve_machine(params)
                n_threads = (int(params["n_threads"])
                             if "n_threads" in params else None)
                seed = int(params.get("seed", 0))
                res, src = svc.cell_with_source(
                    bench, cfg, n_threads, seed, engine=params.get("engine"))
                self._send({
                    "key": cell_key(bench, cfg, n_threads, seed),
                    "machine": cfg.name, "source": src,
                    "result": dataclasses.asdict(res),
                })
            elif path == "/peer/cell":
                self._send(svc.peer_cell(params))
            elif path == "/peer/job":
                job = params["job"]
                with svc._lock:
                    q = svc._jobs.get(job)
                    blob = (None if q is not None
                            else svc._replica_jobs.get(job))
                if q is not None:
                    blob = q.to_dict()
                # Local tables only — never forwards, so adoption scans
                # across the fleet terminate in one hop.
                self._send({"job": job, "found": blob is not None,
                            "queue": blob})
            elif path == "/queue/lease":
                self._send(svc.queue_lease(params["job"],
                                           params.get("worker", "anon")))
            elif path == "/queue/renew":
                self._send(svc.queue_renew(params["job"], params["chunk"],
                                           params.get("worker", "anon")))
            elif path == "/queue/status":
                self._send(svc.queue_status(params["job"]))
            else:
                self._send({"error": f"unknown path {path}"}, 404)

        self._route(handle)

    def do_POST(self):  # noqa: N802 — stdlib naming
        path = urlparse(self.path).path
        svc = self.service

        def handle():
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(length) or b"{}")
            if path == "/study":
                study = Study.from_dict(body.get("study", body))
                self._send(svc.study(study).to_json())
            elif path == "/sweep":
                spec = spec_from_dict(body.get("spec", body))
                if body.get("enqueue"):
                    self._send(svc.enqueue(
                        spec, chunk_size=int(body.get("chunk_size", 16)),
                        lease_seconds=body.get("lease_seconds")))
                    return
                results, stats = svc.sweep(spec, engine=body.get("engine"))
                self._send({
                    "results": _encode_results(results, spec.seeds),
                    "stats": stats,
                    "seeds": list(spec.seeds),
                })
            elif path == "/peer/replicate":
                n = svc.adopt_cell_replicas(body.get("cells", []))
                self._send({"ok": True, "adopted": n})
            elif path == "/peer/job":
                svc.adopt_job_replica(body["job"], body.get("queue"))
                self._send({"ok": True, "job": body["job"]})
            elif path == "/queue/complete":
                self._send(svc.queue_complete(
                    body["job"], body["chunk"], body.get("worker", "anon"),
                    body.get("results", [])))
            elif path == "/admin/drain":
                self._send(svc.drain(
                    wait_seconds=float(body.get("wait_seconds", 10.0))))
            else:
                self._send({"error": f"unknown path {path}"}, 404)

        self._route(handle)


def serve(service: SweepService, host: str = "127.0.0.1", port: int = 0,
          quiet: bool = True) -> ThreadingHTTPServer:
    """Bind the daemon; ``port=0`` picks an ephemeral port. The caller owns
    the loop: ``serve(svc).serve_forever()`` (or run it in a thread)."""
    handler = type("BoundSweepHandler", (SweepRequestHandler,),
                   {"service": service, "quiet": quiet})
    return ThreadingHTTPServer((host, port), handler)


# ---------------------------------------------------------------------------
# Client
# ---------------------------------------------------------------------------


class SweepClient:
    """Talk to a running service; mirrors the in-process sweep API shapes.

    ``sweep()`` returns exactly what ``run_sweep`` would (single-seed flat
    grid, or seed-keyed for multi-seed specs) and stashes the service's
    per-run stats snapshot in :attr:`last_stats`, so call sites swap
    between local and remote execution without reshaping anything.
    """

    def __init__(self, base_url: str, timeout: float = 600.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self.last_stats: Dict = {}

    def _get(self, path: str) -> dict:
        return _http_json(self.base_url + path, timeout=self.timeout)

    def _post(self, path: str, body: dict) -> dict:
        return _http_json(self.base_url + path, body, timeout=self.timeout)

    def healthz(self) -> dict:
        return self._get("/healthz")

    def stats(self) -> dict:
        return self._get("/stats")

    def cell(self, bench: str, machine: str = "ws32",
             **params) -> SimResult:
        q = {"bench": bench, "machine": machine}
        q.update({k: v for k, v in params.items() if v is not None})
        resp = self._get("/cell?" + urlencode(q))
        return SimResult(**resp["result"])

    def sweep(self, spec: SweepSpec, engine: Optional[str] = None) -> Dict:
        body: Dict = {"spec": spec_to_dict(spec)}
        if engine:
            body["engine"] = engine
        resp = self._post("/sweep", body)
        self.last_stats = resp.get("stats", {})
        seeds = [int(s) for s in resp.get("seeds", [0])]
        return _decode_results(resp["results"], seeds)

    def study(self, study: Study) -> StudyResult:
        """Run a typed :class:`~repro_torch.core.warpsim.api.Study` on the
        daemon (``POST /study``); returns the typed
        :class:`~repro_torch.core.warpsim.api.StudyResult` (records + stats,
        also stashed in :attr:`last_stats`)."""
        resp = self._post("/study", {"study": study.to_dict()})
        res = StudyResult.from_json(resp, backend="service")
        self.last_stats = res.stats
        return res

    def run_suite(self, machine_set: Optional[Mapping] = None,
                  benches: Iterable[str] = BENCHMARKS,
                  n_threads: Optional[int] = None, seed: int = 0,
                  seeds: Optional[Iterable[int]] = None,
                  engine: Optional[str] = None) -> Dict:
        """Signature-compatible with :func:`repro_torch.core.warpsim.runner.run_suite`."""
        spec = SweepSpec(
            benches=tuple(benches), machines=machine_set,
            n_threads=n_threads,
            seeds=tuple(seeds) if seeds is not None else (seed,))
        return self.sweep(spec, engine=engine)

    def enqueue(self, spec: SweepSpec, chunk_size: int = 16,
                lease_seconds: Optional[float] = None) -> dict:
        body: Dict = {"spec": spec_to_dict(spec), "enqueue": True,
                      "chunk_size": chunk_size}
        if lease_seconds is not None:
            body["lease_seconds"] = lease_seconds
        return self._post("/sweep", body)

    def queue_status(self, job: str) -> dict:
        return self._get("/queue/status?" + urlencode({"job": job}))

    def drain(self, wait_seconds: float = 10.0) -> dict:
        """Ask the daemon to drain (``POST /admin/drain``): stop leasing,
        finish in-flight cells, persist queue state for its successor."""
        return self._post("/admin/drain", {"wait_seconds": wait_seconds})


@dataclasses.dataclass
class _Endpoint:
    """Per-URL circuit-breaker state inside a :class:`ResilientClient`."""

    url: str
    state: str = "closed"       # closed (usable) | open (cooling down)
    failures: int = 0           # consecutive; reset on success
    successes: int = 0
    open_until: float = 0.0     # clock() time after which a probe may run
    opens: int = 0


class ResilientClient(SweepClient):
    """A :class:`SweepClient` that survives daemons dying under it.

    Wraps every request in: bounded retries of transient failures (5xx /
    no response — 4xx re-raises immediately; every served endpoint is
    idempotent, cells and studies are deterministic and completes are
    idempotent by design, so re-sending is always safe), capped
    exponential backoff with deterministic seeded jitter, and failover
    across `urls` with a per-endpoint circuit breaker: `breaker_threshold`
    consecutive failures open an endpoint, and after `breaker_cooldown`
    (on the injectable `clock`) it is re-admitted only by a successful
    ``/healthz`` probe that is not draining. The most recent good endpoint
    is sticky (`last_url`), so a failover doesn't ping-pong.

    Every request carries a process-unique op id in the ``X-Warpsim-Op``
    header; servers running a :class:`~repro_torch.core.warpsim.faults.FaultPlan`
    key request faults on it, so an injected fault fires once per logical
    operation and the retry goes through — the property the chaos tests
    lean on. `sleep`, `clock`, `transport`, and `fault_plan` are
    injectable so every retry/breaker path is testable without real
    sockets or wall-clock time. Counters (attempts, retries, failovers,
    breaker transitions, probes) surface via :meth:`client_stats` and as
    the ``"client"`` section of :meth:`stats`.
    """

    def __init__(self, urls: Union[str, Sequence[str]],
                 timeout: float = 600.0,
                 attempt_timeout: Optional[float] = None,
                 max_retries: int = 5, backoff_base: float = 0.05,
                 backoff_cap: float = 2.0, breaker_threshold: int = 3,
                 breaker_cooldown: float = 5.0, probe_timeout: float = 5.0,
                 seed: int = 0, sleep=time.sleep, clock=time.monotonic,
                 transport=None,
                 fault_plan: Optional[FaultPlan] = None):
        if isinstance(urls, str):
            urls = [u.strip() for u in urls.split(",") if u.strip()]
        urls = [u.rstrip("/") for u in urls]
        if not urls:
            raise ValueError("ResilientClient needs at least one URL")
        super().__init__(urls[0], timeout=timeout)
        self.endpoints = [_Endpoint(u) for u in urls]
        self.attempt_timeout = attempt_timeout
        self.max_retries = max_retries
        self.backoff_base = backoff_base
        self.backoff_cap = backoff_cap
        self.breaker_threshold = breaker_threshold
        self.breaker_cooldown = breaker_cooldown
        self.probe_timeout = probe_timeout
        self.fault_plan = (FaultPlan.from_env() if fault_plan is None
                           else fault_plan)
        self._sleep = sleep
        self._clock = clock
        self._transport = transport or _http_json
        self._rng = random.Random(seed)
        self._rlock = threading.Lock()
        self._op_seq = 0
        self._preferred = 0
        self.last_url = urls[0]
        # Client-side observability domain (separate registry from any
        # daemon living in the same process): the legacy client_stats()
        # counter dict becomes a view over it, same keys and values.
        self.obs = obs_mod.Observability(clock=clock)
        self.counters = obs_mod.CounterView(self.obs.registry,
                                            _CLIENT_COUNTER_METRICS)
        self._h_request = self.obs.registry.histogram(
            "warpsim_client_request_seconds",
            "end-to-end duration of one logical client operation "
            "(all retries and failovers included)")

    @property
    def urls(self) -> List[str]:
        return [e.url for e in self.endpoints]

    # ----------------------------------------------------------- plumbing

    def _get(self, path: str) -> dict:
        return self._request(path)

    def _post(self, path: str, body: dict) -> dict:
        return self._request(path, body)

    def _bump(self, counter: str, n: int = 1) -> None:
        # Registry-locked, not rlock-guarded: callers already inside
        # `with self._rlock:` (breaker transitions) may bump safely.
        self.counters.inc(counter, n)

    def _backoff(self, n_failures: int) -> float:
        with self._rlock:
            jitter = 0.5 + 0.5 * self._rng.random()
        return min(self.backoff_cap,
                   self.backoff_base * (2 ** n_failures)) * jitter

    def _select(self) -> Optional[_Endpoint]:
        """Next endpoint to try: sticky-closed first, then any open one
        whose cooldown elapsed *and* whose healthz probe passes."""
        with self._rlock:
            order = (self.endpoints[self._preferred:]
                     + self.endpoints[:self._preferred])
            now = self._clock()
            closed = [e for e in order if e.state == "closed"]
            probeable = [e for e in order
                         if e.state == "open" and e.open_until <= now]
        if closed:
            return closed[0]
        for ep in probeable:
            if self._probe(ep):
                return ep
        return None

    def _probe(self, ep: _Endpoint) -> bool:
        self._bump("probes")
        try:
            health = self._transport(ep.url + "/healthz", None,
                                     timeout=self.probe_timeout)
        except ServiceError:
            ok = False
        else:
            ok = bool(health.get("ok")) and not health.get("draining")
        with self._rlock:
            if ok:
                ep.state = "closed"
                ep.failures = 0
                self._bump("breaker_closes")
            else:
                ep.open_until = self._clock() + self.breaker_cooldown
        return ok

    def _record_failure(self, ep: _Endpoint) -> None:
        with self._rlock:
            ep.failures += 1
            if (ep.state == "closed"
                    and ep.failures >= self.breaker_threshold):
                ep.state = "open"
                ep.open_until = self._clock() + self.breaker_cooldown
                ep.opens += 1
                self._bump("breaker_opens")
            # Point the next attempt at a different endpoint right away —
            # failover is immediate; the breaker only governs when a
            # *failing* endpoint may be tried again.
            if len(self.endpoints) > 1:
                idx = self.endpoints.index(ep)
                self._preferred = (idx + 1) % len(self.endpoints)

    def _record_success(self, ep: _Endpoint) -> None:
        with self._rlock:
            ep.successes += 1
            ep.failures = 0
            if ep.state == "open":
                ep.state = "closed"
                self._bump("breaker_closes")
            self._preferred = self.endpoints.index(ep)
            self.last_url = ep.url

    def _request(self, path: str, body: Optional[dict] = None) -> dict:
        with self._rlock:
            self._op_seq += 1
            op = f"{path.split('?')[0]}#{self._op_seq}"
        self._bump("requests")
        last_err: Optional[ServiceError] = None
        attempts = 0
        prev_ep: Optional[_Endpoint] = None
        with self._h_request.time():
            for attempt in range(self.max_retries + 1):
                if attempt:
                    self._bump("retries")
                    self._sleep(self._backoff(attempt - 1))
                ep = self._select()
                if ep is None:
                    # Every breaker open and no probe passed: burn the
                    # attempt and back off — a later attempt may find a
                    # cooldown elapsed and a daemon back up.
                    attempts += 1
                    continue
                if prev_ep is not None and ep is not prev_ep:
                    self._bump("failovers")
                prev_ep = ep
                attempts += 1
                self._bump("attempts")
                fault = (self.fault_plan.check(fault_point("client.request"),
                                               marker=op)
                         if self.fault_plan is not None else None)
                try:
                    if fault is not None:
                        raise ServiceUnavailable(
                            f"injected client fault ({fault.action}) before "
                            f"{ep.url}{path}", url=ep.url, path=path)
                    # Each attempt is its own span; the header carries the
                    # *stable* op (the fault/retry marker) plus this
                    # attempt's span id, so the daemon's server span
                    # chains under the attempt that actually reached it —
                    # a retried op stays one trace, attempts appended.
                    with obs_mod.span("client.attempt", url=ep.url, op=op,
                                      attempt=attempts):
                        out = self._transport(
                            ep.url + path, body,
                            timeout=self.attempt_timeout or self.timeout,
                            headers={OP_HEADER: obs_mod.format_op_header(
                                op, obs_mod.current())})
                except ServiceError as e:
                    if not e.is_transient:
                        e.attempts = attempts
                        raise
                    last_err = e
                    self._record_failure(ep)
                    continue
                self._record_success(ep)
                return out
        self._bump("exhausted")
        err = ServiceUnavailable(
            f"no endpoint served {path.split('?')[0]} after {attempts} "
            f"attempts (tried {', '.join(self.urls)})"
            + (f"; last error: {last_err}" if last_err else ""),
            url=self.urls[0], path=path.split("?")[0], attempts=attempts)
        raise err from last_err

    # -------------------------------------------------------- observability

    def client_stats(self) -> dict:
        with self._rlock:
            return {
                **self.counters,
                "endpoints": {
                    e.url: {"state": e.state, "failures": e.failures,
                            "successes": e.successes,
                            "breaker_opens": e.opens}
                    for e in self.endpoints
                },
            }

    def stats(self) -> dict:
        """Remote ``/stats`` of the current-best daemon, plus a
        ``"client"`` section with this client's retry/failover/breaker
        counters — one call shows both sides of the resilience story."""
        remote = self._request("/stats")
        remote["client"] = self.client_stats()
        return remote


# Dead URLs already warned about (once per (env var, url) per process):
# every sweep of a figure run probing the same dead daemon must not emit
# its own copy of the identical warning.
_WARNED_DEAD_URLS: set = set()  # guarded-by: _WARNED_LOCK
_WARNED_LOCK = threading.Lock()


def _warn_dead(var: str, url: str, err: Exception) -> None:
    with _WARNED_LOCK:
        first = (var, url) not in _WARNED_DEAD_URLS
        _WARNED_DEAD_URLS.add((var, url))
    if first:
        warnings.warn(
            f"{var}={url} set but the service is unreachable "
            f"({err.__class__.__name__}: {err}); falling back to "
            "in-process sweeps", RuntimeWarning, stacklevel=3)


def from_env(var: str = ENV_URL, probe: bool = True
             ) -> Optional[SweepClient]:
    """Client for the service named by the environment, or None.

    ``$WARPSIM_SERVICE_URLS`` (comma-separated) wins and yields a
    :class:`ResilientClient` over the whole fleet; else
    ``$WARPSIM_SERVICE_URL`` yields a plain single-daemon
    :class:`SweepClient`. With `probe` (the default) a dead or
    unreachable service — for the fleet: *every* endpoint down, the
    resilient probe fails over internally — degrades to None with a
    warning; figure generation then falls back to in-process sweeps
    instead of failing, so the env vars can stay exported even when no
    daemon is up. The warning fires exactly once per process for a given
    (env var, URL): repeat callers get the silent fallback.

    `var` must be a ``WARPSIM_*`` name registered in
    :mod:`repro_torch.core.warpsim.envcfg` — the read goes through the
    registry, which raises ``KeyError`` for unregistered names rather
    than returning None.
    """
    if var == ENV_URL:
        fleet = envcfg.get(ENV_URLS)
        if fleet and fleet.strip():
            client = ResilientClient(fleet)
            if probe:
                try:
                    client.healthz()
                except Exception as e:  # noqa: BLE001 — all endpoints dead
                    _warn_dead(ENV_URLS, fleet, e)
                    return None
            return client
    url = envcfg.get(var)
    if not url:
        return None
    client = SweepClient(url)
    if probe:
        try:
            client.healthz()
        except Exception as e:  # noqa: BLE001 — any failure means "no service"
            _warn_dead(var, url, e)
            return None
    return client


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        description="long-lived warp-size sweep result service")
    ap.add_argument("--cache-dir", default=DEFAULT_CACHE_DIR,
                    help=f"ResultCache root (default: {DEFAULT_CACHE_DIR})")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8321,
                    help="0 picks an ephemeral port (printed on startup)")
    ap.add_argument("--engine", default="auto",
                    choices=_cuda.ENGINES,
                    help="cuda: the card's kernel; torch: its plain "
                         "version on the CPU; native, fast, fast_nested, "
                         "event: the host engines, on the host CPU; auto "
                         "(default): by --device")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, default) or cpu; a daemon asked "
                         "for cuda on a host without a card exits non-zero")
    ap.add_argument("--no-persist-traces", action="store_true",
                    help="don't snapshot thread traces under the cache dir")
    ap.add_argument("--lease-seconds", type=float, default=60.0,
                    help="work-queue lease duration")
    ap.add_argument("--peers", default=None,
                    help="comma-separated peer daemon URLs: join a "
                         f"federated mesh (default: ${mesh_mod.ENV_PEERS})")
    ap.add_argument("--advertise-url", default=None,
                    help="this daemon's own peer-visible URL (default: "
                         f"${mesh_mod.ENV_SELF}, else http://<host>:<port> "
                         "after bind)")
    ap.add_argument("--replication", type=int, default=None,
                    help="copies per cell/job across the mesh (default: "
                         f"${mesh_mod.ENV_REPLICATION}, else "
                         f"{mesh_mod.DEFAULT_REPLICATION})")
    ap.add_argument("--verbose", action="store_true",
                    help="log every request to stderr")
    args = ap.parse_args(argv)

    # mesh=False: the env path needs the self URL, which for an
    # ephemeral --port 0 only exists after bind — configure below.
    try:
        service = SweepService(
            args.cache_dir, engine=args.engine, device=args.device,
            persist_traces=not args.no_persist_traces,
            lease_seconds=args.lease_seconds, mesh=False)
    except (RuntimeError, ValueError) as e:
        sys.exit(f"warpsim-sweep-service: not started: {e}")
    httpd = serve(service, host=args.host, port=args.port,
                  quiet=not args.verbose)
    host, port = httpd.server_address[:2]
    peers = args.peers or envcfg.get(mesh_mod.ENV_PEERS) or ""
    mesh_line = ""
    if peers.strip():
        self_url = (args.advertise_url
                    or envcfg.get(mesh_mod.ENV_SELF)
                    or f"http://{host}:{port}")
        replication = args.replication
        if replication is None:
            replication = envcfg.get_int(mesh_mod.ENV_REPLICATION)
        mesh = MeshConfig.build(
            self_url, [p for p in peers.split(",") if p.strip()],
            replication=replication)
        service.configure_mesh(mesh)
        mesh_line = (f", mesh={len(mesh.members)} members "
                     f"x{mesh.replication} as {mesh.self_url}")
    # Machine-parseable startup line (the smoke harness reads the URL).
    print(f"warpsim-sweep-service listening on http://{host}:{port} "
          f"(cache={os.path.abspath(args.cache_dir)}, "
          f"engine={service.engine}, device={service.device}{mesh_line})",
          flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()


if __name__ == "__main__":
    main()
