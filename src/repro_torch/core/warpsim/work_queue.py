"""Lease-based work queue: shard one sweep across cooperating workers.

The port's copy of the reference's work queue, with the reference's
chunking, lease semantics, snapshot format and wire form of cells, so a
worker of either package drains a job of either package's daemon, and a
daemon of either package adopts the other's ``<cache root>/queue/<job>
.json`` snapshots. ``SweepSpec.cells()`` is a fixed, deterministic grid
and cell cache keys are host-independent, so *any* worker on *any* host
can compute *any* cell and the results are exact.

* :class:`WorkQueue` — splits a cell list into chunks (family-major, via
  :func:`~repro_torch.core.warpsim.sweep.family_major_cells`, so one
  chunk's cells share thread traces and aggregated streams inside a
  worker) and hands them out under *leases*: a chunk not completed before
  its lease expires is silently requeued and granted to the next worker,
  so a crashed or wedged worker can never strand part of a sweep.
  Completions are idempotent and late completions from a presumed-dead
  worker are accepted (results are deterministic, so double work is
  wasted effort, never wrong data).
* :func:`run_worker` — the matching worker loop for the HTTP front-end
  the sweep service exposes (``/queue/lease`` + ``/queue/complete``):
  lease a chunk, simulate its cells on `device` (each a one-unit family
  launch of the card's kernel, or its plain version on the CPU) through
  the worker's trace/expansion LRUs, POST the results back (the server
  adopts them into its ResultCache — no shared filesystem required),
  repeat until the job is drained.

The transport (:func:`_http_json`, :func:`_http_text`) speaks
``http.client`` and turns every failure into a typed
:class:`~repro_torch.core.warpsim.faults.ServiceError`.

``python -m repro_torch.core.warpsim.work_queue --url http://HOST:PORT
--job ID [--device cuda|cpu]`` runs a worker process against a remote
service; start as many as you have cards/hosts.
"""

from __future__ import annotations

import argparse
import dataclasses
import http.client
import json
import os
import sys
import threading
import time
import urllib.parse
from typing import Dict, List, Mapping, Optional, Tuple

from repro_torch.core.warpsim.config import MachineConfig
from repro_torch.core.warpsim import envcfg
from repro_torch.core.warpsim import obs as obs_mod
from repro_torch.core.warpsim.faults import (
    FaultPlan, ServiceError, ServiceUnavailable, fault_point,
)
from repro_torch.core.warpsim.sweep import (
    Cell, ExpansionCache, TraceCache, cell_key, compute_cell,
    family_major_cells,
)
from repro_torch.core.warpsim.timing import HOST_ENGINES

_PENDING, _LEASED, _DONE = "pending", "leased", "done"


@dataclasses.dataclass
class Chunk:
    """One leaseable unit of sweep work (a family-major run of cells)."""

    chunk_id: int
    cells: List[Cell]
    state: str = _PENDING
    worker: Optional[str] = None
    deadline: float = 0.0
    attempts: int = 0


class WorkQueue:
    """Sharded, lease-based distribution of one sweep's cells.

    `cells` are reordered family-major and split into chunks of
    `chunk_size` cells (default: one chunk per trace family boundary
    rounded to 16 cells, a balance between lease bookkeeping and
    requeue-on-death granularity). ``lease()`` grants the oldest pending
    chunk for `lease_seconds`; a worker that neither completes nor
    ``renew()``-s in time forfeits the chunk to the next ``lease()``
    caller (``run_worker`` renews between cells, so only a *single cell*
    slower than the lease — not a slow chunk — can forfeit work).
    `clock` is injectable for tests (defaults to ``time.monotonic``).
    `trace_id` ties the job to the study trace that enqueued it: it is
    persisted, handed to workers in every lease response, and joined by
    ``run_worker`` so worker hops land in the same trace. `on_count` is
    an optional ``callback(counter_name)`` fired (under the queue lock)
    whenever one of the lease counters increments — the sweep service
    mirrors them into its metrics registry without this module growing a
    registry dependency of its own.

    Thread-safe: one lock guards all state (the sweep service calls this
    from concurrent request threads).
    """

    def __init__(self, cells: List[Cell], chunk_size: int = 16,
                 lease_seconds: float = 60.0, clock=time.monotonic,
                 trace_id: Optional[str] = None, on_count=None):
        if chunk_size < 1:
            raise ValueError("chunk_size must be >= 1")
        ordered = family_major_cells(list(cells))
        self.chunks: List[Chunk] = [
            Chunk(i, ordered[off:off + chunk_size])
            for i, off in enumerate(range(0, len(ordered), chunk_size))
        ]
        self.total_cells = len(ordered)
        self.lease_seconds = lease_seconds
        self._clock = clock
        self._lock = threading.Lock()
        self.trace_id = trace_id
        self._on_count = on_count
        self.leases_granted = 0
        self.leases_expired = 0
        self.stale_completions = 0

    def _note(self, counter: str) -> None:
        if self._on_count is not None:
            self._on_count(counter)

    def _reclaim_expired(self, now: float) -> None:
        for c in self.chunks:
            if c.state == _LEASED and c.deadline <= now:
                c.state = _PENDING
                c.worker = None
                self.leases_expired += 1
                self._note("leases_expired")

    def lease(self, worker_id: str) -> Optional[Chunk]:
        """Grant the next pending chunk to `worker_id`, or None if no chunk
        is currently pending (the job may still have live leases — check
        :attr:`done` before concluding the sweep is finished)."""
        with self._lock:
            now = self._clock()
            self._reclaim_expired(now)
            for c in self.chunks:
                if c.state == _PENDING:
                    c.state = _LEASED
                    c.worker = worker_id
                    c.deadline = now + self.lease_seconds
                    c.attempts += 1
                    self.leases_granted += 1
                    self._note("leases_granted")
                    return c
            return None

    def renew(self, chunk_id: int, worker_id: str) -> bool:
        """Extend a live lease by another `lease_seconds`.

        False when the chunk is no longer leased to `worker_id` — its
        lease expired and was (or can be) re-granted, or it was completed
        — in which case the worker should abandon the chunk rather than
        race a sibling on it.
        """
        with self._lock:
            if not 0 <= chunk_id < len(self.chunks):
                return False
            now = self._clock()
            self._reclaim_expired(now)
            c = self.chunks[chunk_id]
            if c.state != _LEASED or c.worker != worker_id:
                return False
            c.deadline = now + self.lease_seconds
            return True

    def complete(self, chunk_id: int, worker_id: str) -> bool:
        """Mark a chunk done. Returns False only for an unknown chunk.

        Idempotent, and deliberately accepts completions from a worker
        whose lease already expired (or was re-granted): its results are
        byte-identical to any other worker's, so discarding them would
        only waste the work. ``stale_completions`` counts those arrivals.
        """
        with self._lock:
            if not 0 <= chunk_id < len(self.chunks):
                return False
            c = self.chunks[chunk_id]
            if c.state == _DONE:
                return True
            if c.worker != worker_id:
                self.stale_completions += 1
                self._note("stale_completions")
            c.state = _DONE
            c.worker = worker_id
            if all(ch.state == _DONE for ch in self.chunks):
                # The job is drained; the cell payloads (config dicts per
                # cell) are dead weight in a long-lived daemon — drop them
                # (status() reports total_cells, captured at init).
                for ch in self.chunks:
                    ch.cells = []
            return True

    @property
    def done(self) -> bool:
        with self._lock:
            return all(c.state == _DONE for c in self.chunks)

    # ------------------------------------------------------- persistence

    def to_dict(self) -> dict:
        """JSON-safe snapshot of the whole queue (sweep service crash
        recovery: jobs are rewritten under the cache root on every
        enqueue/lease/complete).

        Lease deadlines are monotonic-clock values, meaningless to another
        process — they are stored as *remaining* seconds and re-anchored
        to the loader's clock, so a lease keeps (at most) its remaining
        time across a daemon restart and then expires/requeues normally.
        """
        with self._lock:
            now = self._clock()
            return {
                "total_cells": self.total_cells,
                "lease_seconds": self.lease_seconds,
                "trace": self.trace_id,
                "leases_granted": self.leases_granted,
                "leases_expired": self.leases_expired,
                "stale_completions": self.stale_completions,
                "chunks": [{
                    "chunk_id": c.chunk_id,
                    "cells": [cell_to_wire(cell) for cell in c.cells],
                    "state": c.state,
                    "worker": c.worker,
                    "attempts": c.attempts,
                    "lease_remaining": (max(0.0, c.deadline - now)
                                        if c.state == _LEASED else 0.0),
                } for c in self.chunks],
            }

    @classmethod
    def from_dict(cls, d: Mapping, clock=time.monotonic,
                  on_count=None) -> "WorkQueue":
        """Inverse of :meth:`to_dict` — restores chunk boundaries, states,
        workers and counters verbatim (no re-sharding: chunk ids must stay
        stable so in-flight workers' renew/complete calls keep landing)."""
        q = cls.__new__(cls)
        q.total_cells = int(d["total_cells"])
        q.lease_seconds = float(d["lease_seconds"])
        q._clock = clock
        q._lock = threading.Lock()
        q.trace_id = d.get("trace")
        q._on_count = on_count
        q.leases_granted = int(d.get("leases_granted", 0))
        q.leases_expired = int(d.get("leases_expired", 0))
        q.stale_completions = int(d.get("stale_completions", 0))
        now = clock()
        q.chunks = [
            Chunk(int(cd["chunk_id"]),
                  [cell_from_wire(w) for w in cd["cells"]],
                  state=cd["state"], worker=cd.get("worker"),
                  deadline=(now + float(cd.get("lease_remaining", 0.0))
                            if cd["state"] == _LEASED else 0.0),
                  attempts=int(cd.get("attempts", 0)))
            for cd in d["chunks"]
        ]
        return q

    def status(self) -> Dict[str, int]:
        with self._lock:
            self._reclaim_expired(self._clock())
            by_state = {_PENDING: 0, _LEASED: 0, _DONE: 0}
            for c in self.chunks:
                by_state[c.state] += 1
            return {
                "chunks": len(self.chunks),
                "cells": self.total_cells,
                "pending": by_state[_PENDING],
                "leased": by_state[_LEASED],
                "completed": by_state[_DONE],
                "leases_granted": self.leases_granted,
                "leases_expired": self.leases_expired,
                "stale_completions": self.stale_completions,
            }


# ---------------------------------------------------------------------------
# Wire encoding (shared by the service handler and the worker loop)
# ---------------------------------------------------------------------------


def cell_to_wire(cell: Cell) -> dict:
    mname, cfg, bench, n_threads, seed = cell
    return {"machine": mname, "config": dataclasses.asdict(cfg),
            "bench": bench, "n_threads": n_threads, "seed": seed}


def cell_from_wire(d: dict) -> Cell:
    return (d["machine"], MachineConfig(**d["config"]), d["bench"],
            d.get("n_threads"), d.get("seed", 0))


# ---------------------------------------------------------------------------
# HTTP worker loop
# ---------------------------------------------------------------------------


def _round_trip(url: str, data: Optional[bytes], timeout: float,
                headers: Mapping[str, str]) -> Tuple[int, bytes]:
    """One HTTP exchange: ``(status, body)``. A POST when `data` is given,
    else a GET. Raises what ``http.client`` and the socket raise."""
    parts = urllib.parse.urlsplit(url)
    if parts.scheme == "https":
        conn: http.client.HTTPConnection = http.client.HTTPSConnection(
            parts.hostname, parts.port, timeout=timeout)
    elif parts.scheme == "http":
        conn = http.client.HTTPConnection(parts.hostname, parts.port,
                                          timeout=timeout)
    else:
        raise http.client.InvalidURL(f"unsupported URL scheme in {url!r}")
    target = (parts.path or "/") + (f"?{parts.query}" if parts.query else "")
    try:
        conn.request("GET" if data is None else "POST", target, body=data,
                     headers=dict(headers))
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _exchange(url: str, data: Optional[bytes], timeout: float,
              headers: Mapping[str, str]) -> bytes:
    """The body of a 2xx response to one request, with *typed* failures.

    A definite HTTP error status maps to :class:`ServiceError` (carrying
    the code and any server-side ``error`` detail of a JSON body), while
    connection refusal/reset, timeouts and protocol violations map to
    :class:`ServiceUnavailable` (no usable response — the retryable
    family).
    """
    parts = urllib.parse.urlsplit(url)
    base = f"{parts.scheme}://{parts.netloc}"   # error context: endpoint,
    path = parts.path or "/"                    # not the full request URL
    try:
        status, payload = _round_trip(url, data, timeout, headers)
    except (http.client.HTTPException, OSError, ValueError) as e:
        raise ServiceUnavailable(
            f"{type(e).__name__} talking to {url}: {e}",
            url=base, path=path) from e
    if not 200 <= status < 300:
        detail = ""
        try:
            blob = json.loads(payload.decode())
            if blob.get("error"):
                detail = f": {blob['error']}"
        except (ValueError, AttributeError):
            pass
        raise ServiceError(f"HTTP {status} from {url}{detail}",
                           url=base, path=path, code=status)
    return payload


def _http_json(url: str, body: Optional[dict] = None,
               timeout: float = 60.0,
               headers: Optional[Mapping[str, str]] = None) -> dict:
    """One JSON-over-HTTP round trip (a POST of `body` when given, else a
    GET) with the typed failures of :func:`_exchange`; an undecodable
    body is :class:`ServiceUnavailable` too."""
    data = json.dumps(body).encode() if body is not None else None
    hdrs = {"Content-Type": "application/json"} if data else {}
    if headers:
        hdrs.update(headers)
    payload = _exchange(url, data, timeout, hdrs)
    try:
        return json.loads(payload.decode())
    except ValueError as e:
        parts = urllib.parse.urlsplit(url)
        raise ServiceUnavailable(
            f"undecodable response from {url}: {e}",
            url=f"{parts.scheme}://{parts.netloc}",
            path=parts.path or "/") from e


def _http_text(url: str, timeout: float = 60.0) -> str:
    """One text-over-HTTP GET with the same typed-failure contract as
    :func:`_http_json` — for non-JSON surfaces, i.e. the daemon's
    Prometheus ``GET /metrics`` exposition (smokes and scrapers)."""
    return _exchange(url, None, timeout, {}).decode()


def _worker_urls(base_url) -> List[str]:
    """Normalize ``run_worker``'s first argument into an ordered URL list.

    Accepts a single URL, a comma-separated fleet (the
    ``$WARPSIM_SERVICE_URLS`` wire format), any sequence of URLs, or a
    client object (e.g. :class:`~repro_torch.core.warpsim.service.ResilientClient`
    via its ``urls``, or a plain SweepClient via ``base_url``).
    """
    if hasattr(base_url, "urls"):
        urls = list(base_url.urls)
    elif hasattr(base_url, "base_url"):
        urls = [base_url.base_url]
    elif isinstance(base_url, str):
        urls = [u for u in (p.strip() for p in base_url.split(",")) if u]
    else:
        urls = [str(u).strip() for u in base_url]
    out: List[str] = []
    for u in urls:
        u = u.rstrip("/")
        if u and u not in out:
            out.append(u)
    if not out:
        raise ValueError("run_worker needs at least one service URL")
    return out


def run_worker(base_url, job: str, worker_id: Optional[str] = None,
               engine: str = "auto", device="cuda",
               poll_seconds: float = 0.5,
               max_chunks: Optional[int] = None,
               timeout: float = 300.0, max_retries: int = 3,
               retry_backoff: float = 0.1, sleep=time.sleep,
               fault_plan: Optional[FaultPlan] = None) -> int:
    """Drain chunks of `job` from a sweep service until it is done.

    Computes every leased cell locally on `device` with `engine` (a
    one-unit family launch of the card's kernel per cell, or its plain
    version on the CPU; through trace/expansion LRUs that live as long as
    this call — chunks are family-major, so one chunk usually needs a
    single thread trace) and POSTs the results back for the server to
    adopt into its cache. Returns the number of cells computed.
    `max_chunks` bounds the number of chunks processed (tests use it to
    simulate a worker dying mid-job).

    `base_url` names the daemon — or the *fleet*: a comma-separated
    string (the ``$WARPSIM_SERVICE_URLS`` format), a sequence of URLs,
    or a client object with ``.urls`` (a ``ResilientClient``). With more
    than one URL the worker is no longer pinned to the enqueuing daemon:
    transient failures rotate to the next endpoint, and a definite
    "unknown job" (400) also rotates — under a mesh a sibling daemon
    adopts the job from its replicas, and under a shared cache root a
    successor daemon reloads it — raising only once *every* endpoint has
    given a definite refusal.

    Resilience: every HTTP call retries transient failures (connection
    loss, 5xx, injected faults) up to `max_retries` times with capped
    exponential backoff before giving up, rotating endpoints between
    attempts. A renew that still fails (or is refused) abandons the
    chunk — the lease expires and a sibling worker requeues it. A
    complete that still fails is *dropped silently*: the chunk requeues
    via lease expiry and completes are idempotent, so the recomputation
    is wasted effort, never wrong or double-adopted data. Only a
    persistently unreachable ``/queue/lease`` raises (the fleet is gone
    and there is nothing useful left to do). `sleep` is injectable so
    tests drive retries and lease expiry with a fake clock; `fault_plan`
    (default: ``$WARPSIM_FAULTS``) injects ``worker.lease`` /
    ``worker.renew`` / ``worker.complete`` faults: ``drop`` simulates
    connection loss, ``corrupt`` mangles the POST body so the server
    rejects it (the retry must then adopt results exactly once).
    """
    bases = _worker_urls(base_url)
    tcache, ecache = TraceCache(), ExpansionCache()
    wid = worker_id or f"{os.uname().nodename}:{os.getpid()}"
    plan = FaultPlan.from_env() if fault_plan is None else fault_plan
    active = [0]    # sticky endpoint index, shared across calls

    def call(kind: str, path: str, body: Optional[dict] = None) -> dict:
        last: Optional[ServiceError] = None
        refused = set()     # endpoints that gave a definite non-transient no
        attempt = 0
        while True:
            base = bases[active[0] % len(bases)]
            send = body
            fault = (plan.check(fault_point(f"worker.{kind}"))
                     if plan is not None else None)
            try:
                if fault is not None:
                    if fault.action == "corrupt" and body is not None:
                        send = dict(body, results="!injected-corruption!")
                    else:
                        raise ServiceUnavailable(
                            f"injected worker fault ({fault.action}) at "
                            f"worker.{kind}", url=base, path=f"/{kind}")
                with obs_mod.stage(f"worker.{kind}"):
                    return _http_json(base + path, send, timeout=timeout,
                                      headers=obs_mod.trace_headers())
            except ServiceError as e:
                if not e.is_transient:
                    # Definite refusal (e.g. 400 unknown job) from this
                    # endpoint: a sibling may still know the job — raise
                    # only when the whole fleet has refused.
                    refused.add(base)
                    if len(refused) >= len(bases):
                        raise
                    active[0] = (active[0] + 1) % len(bases)
                    continue
                last = e
                if attempt >= max_retries:
                    break
                sleep(min(2.0, retry_backoff * (2 ** attempt)))
                attempt += 1
                active[0] = (active[0] + 1) % len(bases)
        last.attempts = max_retries + 1
        raise last

    computed = 0
    chunks_done = 0
    while True:
        if max_chunks is not None and chunks_done >= max_chunks:
            return computed
        got = call("lease", f"/queue/lease?job={job}&worker={wid}")
        if got.get("chunk") is None:
            if got.get("done"):
                return computed
            sleep(poll_seconds)     # live leases elsewhere: wait them out
            continue
        # Leases carry the enqueuing study's trace id: every cell, renew
        # heartbeat and completion of this chunk lands in that trace (the
        # spans record into *this worker's* ring; the daemon-side server
        # spans of the renew/complete hops chain to them via the header).
        with obs_mod.join_trace(got.get("trace"), "worker.chunk",
                                parent=got.get("trace_span"), job=job,
                                chunk=got["chunk"], worker=wid):
            results = []
            abandoned = False
            cells = got["cells"]
            for i, wire in enumerate(cells):
                mname, cfg, bench, n_threads, seed = cell_from_wire(wire)
                res = compute_cell(bench, cfg, n_threads=n_threads,
                                   seed=seed, engine=engine, device=device,
                                   trace_cache=tcache,
                                   expansion_cache=ecache)
                results.append({
                    "key": cell_key(bench, cfg, n_threads, seed),
                    "result": dataclasses.asdict(res),
                })
                computed += 1
                if i + 1 < len(cells):
                    # Heartbeat between cells so a slow chunk keeps its
                    # lease (only a single cell slower than the lease can
                    # forfeit).
                    try:
                        renewed = call(
                            "renew", f"/queue/renew?job={job}"
                            f"&chunk={got['chunk']}&worker={wid}")
                    except ServiceError:
                        abandoned = True  # daemon unreachable: requeue
                        break
                    if not renewed.get("ok"):
                        abandoned = True  # lease lost: someone else owns it
                        break
            if not abandoned:
                try:
                    call("complete", "/queue/complete", {
                        "job": job, "chunk": got["chunk"], "worker": wid,
                        "results": results,
                    })
                except ServiceError:
                    # Lost ack: the lease expires, the chunk requeues, and
                    # the eventual duplicate complete is idempotent by
                    # design.
                    pass
        chunks_done += 1


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        description="warpsim sweep worker: drain a job from a sweep service")
    ap.add_argument("--url", default=None,
                    help="service base URL(s), comma-separated for a fleet "
                         "(default: $WARPSIM_SERVICE_URLS, else "
                         "$WARPSIM_SERVICE_URL)")
    ap.add_argument("--job", required=True, help="job id from POST /sweep")
    ap.add_argument("--worker-id", default=None)
    ap.add_argument("--engine", default="auto",
                    choices=("auto", "cuda", "torch") + HOST_ENGINES,
                    help="cuda: the card's kernel; torch: its plain "
                         "version on the CPU; native, fast, fast_nested, "
                         "event: the host engines, on the host CPU; auto: "
                         "by --device")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card, default) or cpu")
    ap.add_argument("--poll-seconds", type=float, default=0.5)
    args = ap.parse_args(argv)
    # Env names are literals here: service.py imports this module, so the
    # constants (service.ENV_URL/ENV_URLS) can't be imported back.
    urls = (args.url or envcfg.get("WARPSIM_SERVICE_URLS")
            or envcfg.get("WARPSIM_SERVICE_URL"))
    if not urls:
        ap.error("--url is required (or set WARPSIM_SERVICE_URLS / "
                 "WARPSIM_SERVICE_URL)")
    n = run_worker(urls, args.job, worker_id=args.worker_id,
                   engine=args.engine, device=args.device,
                   poll_seconds=args.poll_seconds)
    print(f"worker drained: {n} cells computed", file=sys.stderr)


if __name__ == "__main__":
    main()
