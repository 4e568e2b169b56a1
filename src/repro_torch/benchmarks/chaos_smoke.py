"""Chaos smoke of the port: kill a daemon mid-study, flap the network,
corrupt a worker; the client never notices and every record stays
bit-identical.

The port's counterpart of the reference's ``benchmarks/chaos_smoke.py``,
with its scenarios, studies and fault specs. Daemons compute on
`--device` (the card by default: each simulated cell one one-unit
``ws_family_kernel`` launch; ``--device cpu`` runs the kernel's plain
version, engine ``torch``). The fault schedules are seeded
:class:`~repro_torch.core.warpsim.faults.FaultPlan`\\ s. Three scenarios:

1. **daemon-kill failover**: two in-process daemons over one shared cache
   root; an injected ``service.cell:kill`` murders daemon A mid-study and
   daemon B 503s its first request; a :class:`ResilientClient` retries
   and fails over, and the records are bit-identical to in-process, with
   zero duplicate simulations across the pair.
2. **flaky network**, through the ``WARPSIM_FAULTS`` environment
   variable, the way an operator injects faults: one daemon, started as
   a child process with the plan in its environment
   (``service_smoke.boot_daemon(..., extra_env=...)``), whose first
   ``/study`` response is a 503 and whose second is computed then
   dropped (a lost ack); the third attempt is served from the cache, so
   the daemon simulated each cell exactly once. Its counters come from
   ``/stats``, its launches from ``/healthz``.
3. **worker corruption + drain**: a queue worker whose first ``complete``
   POST is corrupted retries cleanly (no duplicate adoption);
   ``POST /admin/drain`` then refuses new work and persists the queue,
   and a successor daemon over the same root adopts the job and serves
   its cells from the cache.

On the card every scenario also checks one launch a simulated cell: the
delta of this process's ``ws_family_kernel`` count against the in-process
daemons' ``simulated`` counters plus the cells a worker here computed,
and the child daemon's ``/healthz`` launches against its ``/stats``.
Without a card and without ``--device cpu`` it exits non-zero ("no CUDA
device"). Exit code 0 iff every check holds::

    PYTHONPATH=src python -m repro_torch.benchmarks.chaos_smoke [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

from repro_torch.benchmarks import service_smoke as smoke
from repro_torch.benchmarks.service_smoke import (
    SmokeFailure, check, daemon, noop_sleep,
)
from repro_torch.benchmarks.service_smoke import small_study as _study
from repro_torch.core.warpsim import _cuda, api
from repro_torch.core.warpsim.api import ServiceBackend, Session
from repro_torch.core.warpsim.faults import FaultPlan, ServiceError
from repro_torch.core.warpsim.service import (
    ResilientClient, SweepClient, SweepService,
)
from repro_torch.core.warpsim.work_queue import run_worker

FLAKY_FAULTS = "server/study:error=503,times=1;response/study:drop,times=1"


def scenario_daemon_kill(reference, tmp, device="cuda") -> dict:
    study = _study(seeds=(0, 1))
    cells = len(study.cells())
    root = os.path.join(tmp, "kill-cache")
    svc_a = SweepService(root, device=device, persist_traces=False,
                         fault_plan=FaultPlan.from_spec(
                             f"service.cell:kill,after={cells - 3}"))
    svc_b = SweepService(root, device=device, persist_traces=False,
                         fault_plan=FaultPlan.from_spec(
                             "server/study:error=503,times=1"))
    n0 = smoke.kernel_launches()
    t0 = time.perf_counter()
    with daemon(svc_a) as url_a, daemon(svc_b) as url_b:
        for url in (url_a, url_b):
            smoke.check_health(url, device)
        client = ResilientClient([url_a, url_b], max_retries=8,
                                 breaker_threshold=99, seed=0,
                                 sleep=noop_sleep, timeout=120.0)
        result = Session(device=device, backend=ServiceBackend(
            client=client)).run(study)
        wall = time.perf_counter() - t0
        cstats = client.client_stats()
        # The mesh surface exists even on an unfederated daemon: /stats
        # carries the counters, /healthz reports membership disabled.
        b = SweepClient(url_b, timeout=30.0)
        mesh_stats, mesh_health = b.stats()["mesh"], b.healthz()["mesh"]
        check(mesh_health == {"enabled": False}, f"mesh {mesh_health}")
        launched = smoke.kernel_launches() - n0
    check(result.records == reference.records, "records diverged")
    check(svc_a.dead, "the injected kill never fired")
    sims = [svc_a.counters["simulated"], svc_b.counters["simulated"]]
    total_sim = sum(sims)
    check(total_sim == cells,
          f"{total_sim} simulations for {cells} cells (duplicates!)")
    check(cstats["retries"] >= 2 and cstats["failovers"] >= 1, str(cstats))
    smoke.check_launches("daemon-kill", launched, total_sim, device)
    print(f"chaos-smoke: daemon-kill {wall:.1f}s — daemon A "
          f"killed after {sims[0]} cells, "
          f"{cstats['retries']} retries / {cstats['failovers']} failovers, "
          f"records bit-identical, {total_sim}/{cells} single simulations")
    print(f"  daemon B /healthz mesh: {mesh_health} | /stats mesh: "
          f"{mesh_stats}")
    return {"wall_s": wall, "cells": cells, "simulated": sims,
            "retries": cstats["retries"], "failovers": cstats["failovers"],
            "launches": launched, "records": result.records}


def scenario_flaky_network(reference, tmp, device="cuda") -> dict:
    study = _study(seeds=(0, 1))
    cells = len(study.cells())
    t0 = time.perf_counter()
    # The plan reaches the daemon through its environment, as an
    # operator's would: the daemon is a child process.
    with smoke.boot_daemon(os.path.join(tmp, "flaky-cache"), device=device,
                           engine=_cuda.resolve_engine("auto", device),
                           extra_env={"WARPSIM_FAULTS": FLAKY_FAULTS}) as url:
        boot = time.perf_counter() - t0
        smoke.check_health(url, device)
        n0 = smoke.launches(url)
        t0 = time.perf_counter()
        client = ResilientClient([url], max_retries=8, seed=0,
                                 sleep=noop_sleep, timeout=120.0)
        result = Session(device=device, backend=ServiceBackend(
            client=client)).run(study)
        wall = time.perf_counter() - t0
        cstats = client.client_stats()
        counters = SweepClient(url, timeout=30.0).stats()["counters"]
        launched = smoke.launches(url) - n0
    check(result.records == reference.records, "records diverged")
    # Attempt 1 ate the 503, attempt 2 computed but lost its ack, attempt
    # 3 was pure cache — each cell simulated exactly once regardless.
    check(cstats["retries"] == 2, str(cstats))
    check(counters["simulated"] == cells, str(counters))
    check(counters["faults_injected"] == 2, str(counters))
    smoke.check_launches("flaky-network", launched, counters["simulated"],
                         device)
    print(f"chaos-smoke: flaky-network {wall:.1f}s — 503 then "
          f"lost ack then cache, {counters['simulated']}/{cells} "
          f"single simulations, records bit-identical")
    return {"boot_s": boot, "wall_s": wall, "cells": cells,
            "simulated": counters["simulated"],
            "faults_injected": counters["faults_injected"],
            "retries": cstats["retries"], "launches": launched,
            "records": result.records}


def scenario_worker_corruption_and_drain(tmp, device="cuda") -> dict:
    root = os.path.join(tmp, "queue-cache")
    svc = SweepService(root, device=device, persist_traces=False)
    study = _study(benches=("BFS",))
    spec = study.to_spec()
    cells = len(spec.cells())
    n0 = smoke.kernel_launches()
    t0 = time.perf_counter()
    with daemon(svc) as url:
        smoke.check_health(url, device)
        job = svc.enqueue(spec, chunk_size=2, lease_seconds=60.0)
        n = run_worker(
            url, job["job"], worker_id="chaos-w1", device=device,
            poll_seconds=0.01, sleep=noop_sleep,
            fault_plan=FaultPlan.from_spec("worker.complete:corrupt,times=1"))
        check(n == cells, f"worker computed {n}/{cells} cells")
        adopted = svc.counters["queue_cells_adopted"]
        check(adopted == cells, f"{adopted} adoptions (duplicate/missing)")
        check(svc.counters["errors"] >= 1, "corrupt POST never rejected")
        client = SweepClient(url, timeout=30.0)
        out = client.drain(wait_seconds=0.5)
        check(out["ok"] and out["draining"], str(out))
        check(client.healthz()["draining"], "healthz: not draining")
        try:
            client.cell("BFS", machine="ws8")
        except ServiceError as e:
            check(e.code == 503, f"draining daemon answered {e}")
        else:
            raise SmokeFailure("draining daemon accepted new work")
    smoke.check_launches("worker", smoke.kernel_launches() - n0,
                         n + svc.counters["simulated"], device)
    heir = SweepService(root, device=device, persist_traces=False)
    status = heir.queue_status(job["job"])
    check(status["chunks"] == job["chunks"], str(status))
    # The successor serves the worker's cells from the root it adopted.
    n0 = smoke.kernel_launches()
    served = heir.study(study)
    check(served.stats["simulated"] == 0
          and smoke.kernel_launches() == n0,
          f"the successor re-simulated: {served.stats}")
    wall = time.perf_counter() - t0
    print(f"chaos-smoke: worker-corruption+drain {wall:.1f}s — "
          f"{adopted}/{cells} single adoptions after a corrupted complete, "
          f"drain persisted {out['jobs_persisted']} job(s), successor "
          f"adopted the queue")
    return {"wall_s": wall, "cells": cells, "worker_cells": n,
            "adopted": adopted, "jobs_persisted": out["jobs_persisted"],
            "records": served.records}


def run(device="cuda", reference=None) -> dict:
    """Every scenario on `device`; `reference` is the in-process records of
    the SMALL study (computed here on `device` when not given). Returns
    each scenario's numbers by name."""
    if reference is None:
        reference = api.Session(device=device).run(_study(seeds=(0, 1)))
    print(f"chaos-smoke: reference study in-process, "
          f"{len(reference.records)} records")
    with tempfile.TemporaryDirectory(prefix="warpsim-chaos-smoke-") as tmp:
        out = {"daemon_kill": scenario_daemon_kill(reference, tmp, device),
               "flaky_network": scenario_flaky_network(reference, tmp,
                                                       device),
               "worker_drain": scenario_worker_corruption_and_drain(
                   tmp, device)}
    print("chaos-smoke OK")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.benchmarks.chaos_smoke",
        description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="the daemons' and this process's device: cuda "
                         "(default) or cpu")
    run(ap.parse_args(argv).device)


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as e:
        sys.exit(f"chaos-smoke: FAIL: {e}")
