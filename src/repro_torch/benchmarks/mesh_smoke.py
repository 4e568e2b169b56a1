"""Mesh smoke of the port: 3 daemons over DISJOINT cache roots, the owner
killed mid-study; records bit-identical to in-process, duplicate
simulations bounded by the replication factor.

The port's counterpart of the reference's ``benchmarks/mesh_smoke.py``,
with its scenarios, studies and fault specs. Daemons are in-process
``serve()`` threads computing on `--device` (the card by default: each
simulated cell one one-unit ``ws_family_kernel`` launch; ``--device cpu``
runs the kernel's plain version, engine ``torch``). Nothing here shares a
filesystem: each daemon owns a private cache root, and a cell crosses
daemons only by the mesh's read-through (``GET /peer/cell``) and
replication (``POST /peer/replicate``). Three scenarios:

1. **cold study + warm peer serving**: a cold study through the fleet
   simulates every cell exactly once fleet-wide (ownership dedups across
   daemons); a warm re-study pointed at a *different* daemon simulates
   zero new cells (replicas and read-through serve it all).
2. **owner killed mid-study**: the daemon serving the study is murdered
   after K simulated cells; the ResilientClient fails over, a sibling
   re-serves from replicas, records stay bit-identical, and duplicate
   simulations are bounded by the replication factor.
3. **queue-job adoption**: a job enqueued on daemon A whose first lease
   request kills A: the fleet-aware worker (this process, on `--device`)
   rotates, a sibling adopts the job from its replica, and the
   QueueBackend study result is bit-identical.

On the card each scenario also checks one launch a simulated cell: the
delta of this process's ``ws_family_kernel`` count equals the daemons'
``simulated`` counters plus the cells the worker computed, and a warm
pass launches nothing. Without a card and without ``--device cpu`` it
exits non-zero ("no CUDA device"). Exit code 0 iff every check holds::

    PYTHONPATH=src python -m repro_torch.benchmarks.mesh_smoke [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

from repro_torch.benchmarks import service_smoke as smoke
from repro_torch.benchmarks.service_smoke import (
    REPLICATION, SmokeFailure, check,
)
from repro_torch.benchmarks.service_smoke import fleet_client as _client
from repro_torch.benchmarks.service_smoke import small_study as _study
from repro_torch.core.warpsim import api
from repro_torch.core.warpsim.api import QueueBackend, ServiceBackend, Session
from repro_torch.core.warpsim.faults import FaultPlan
from repro_torch.core.warpsim.service import SweepClient
from repro_torch.core.warpsim.sweep import cell_key


def mesh_trio(tmp, tag, device="cuda", fault_plans=None):
    """Three meshed daemons on `device` over disjoint roots under
    `tmp`/`tag`-N."""
    return smoke.mesh_fleet(tmp, tag, 3, device, fault_plans)


def _simulated(svcs) -> list:
    return [s.counters["simulated"] for s in svcs]


def _print_mesh(label, svcs):
    for i, svc in enumerate(svcs):
        print(f"  {label} daemon{i} mesh: "
              f"{json.dumps(svc.mesh_stats(), sort_keys=True)}")


def scenario_cold_then_warm(reference, tmp, device="cuda",
                            study=None) -> dict:
    study = study or _study(seeds=(0, 1))
    cells = len(study.cells())
    with mesh_trio(tmp, "cold", device) as (svcs, urls):
        n0 = smoke.kernel_launches()
        t0 = time.perf_counter()
        res = Session(device=device, backend=ServiceBackend(
            client=_client(urls))).run(study)
        cold_s = time.perf_counter() - t0
        cold_launches = smoke.kernel_launches() - n0
        check(res.records == reference.records, "records diverged")
        spread = _simulated(svcs)
        total = sum(spread)
        check(total == cells,
              f"{total} simulations for {cells} cells across the fleet")
        smoke.check_launches("mesh cold", cold_launches, total, device)
        # Warm re-study through ONE other daemon: everything it does not
        # own arrives by read-through/replica — zero new simulations.
        n0 = smoke.kernel_launches()
        t0 = time.perf_counter()
        warm = SweepClient(urls[2], timeout=120.0).study(study)
        warm_s = time.perf_counter() - t0
        warm_launches = smoke.kernel_launches() - n0
        check(warm.records == reference.records, "warm records diverged")
        check(warm.stats["simulated"] == 0, str(warm.stats))
        check(sum(_simulated(svcs)) == cells, "the warm pass simulated")
        smoke.check_launches("mesh warm", warm_launches, 0, device)
        mesh = [svc.mesh_stats() for svc in svcs]
        _print_mesh("cold", svcs)
    print(f"mesh-smoke: cold+warm {cold_s + warm_s:.1f}s — {cells} cells "
          f"simulated once fleet-wide (spread {spread}) over disjoint "
          f"roots, warm re-study via another daemon simulated 0")
    return {"cold_s": cold_s, "warm_s": warm_s, "cells": cells,
            "simulated": spread, "cold_launches": cold_launches,
            "warm_launches": warm_launches,
            "cold_stats": res.stats, "warm_stats": warm.stats,
            "mesh": mesh, "records": res.records}


def scenario_owner_killed_mid_study(reference, tmp, device="cuda") -> dict:
    study = _study(seeds=(0, 1))
    spec = study.to_spec()
    cells = len(spec.cells())
    with mesh_trio(tmp, "kill", device) as (svcs, urls):
        # Ownership depends on the (ephemeral) URLs, so the victim is
        # chosen after bind: the daemon owning the most cells serves the
        # study and is killed on its 3rd simulated cell — pigeonhole
        # over 8 cells / 3 members guarantees it owns at least 3, so the
        # kill always fires mid-study.
        owned = {u: 0 for u in urls}
        for _m, cfg, bench, n_threads, seed in spec.cells():
            owned[svcs[0].mesh.owner(
                cell_key(bench, cfg, n_threads, seed))] += 1
        victim = max(urls, key=lambda u: owned[u])
        vidx = urls.index(victim)
        check(owned[victim] >= 3, f"ownership {owned}")
        svcs[vidx].fault_plan = FaultPlan.from_spec(
            "service.cell:kill,after=2")
        client = _client([victim] + [u for u in urls if u != victim])
        n0 = smoke.kernel_launches()
        t0 = time.perf_counter()
        # Session.run must surface nothing but a clean StudyResult.
        res = Session(device=device, backend=ServiceBackend(
            client=client)).run(study)
        wall = time.perf_counter() - t0
        launched = smoke.kernel_launches() - n0
        cstats = client.client_stats()
        check(res.records == reference.records, "records diverged")
        check(svcs[vidx].dead, "the injected kill never fired")
        spread = _simulated(svcs)
        total = sum(spread)
        duplicates = total - cells
        check(0 <= duplicates <= REPLICATION,
              f"{duplicates} duplicate simulations — the replication "
              f"factor ({REPLICATION}) must bound re-work")
        check(cstats["failovers"] >= 1, str(cstats))
        smoke.check_launches("owner-kill", launched, total, device)
        _print_mesh("kill", svcs)
    print(f"mesh-smoke: owner-kill {wall:.1f}s — daemon{vidx} "
          f"(and its private cache root) died after "
          f"{spread[vidx]} cells; {cstats['retries']} "
          f"retries / {cstats['failovers']} failovers, records "
          f"bit-identical, {duplicates} duplicate sims "
          f"(bound {REPLICATION})")
    return {"wall_s": wall, "cells": cells, "victim": vidx,
            "simulated": spread, "duplicates": duplicates,
            "retries": cstats["retries"], "failovers": cstats["failovers"],
            "launches": launched, "records": res.records}


def scenario_queue_job_adoption(reference, tmp, device="cuda") -> dict:
    study = _study(seeds=(0, 1))
    cells = len(study.cells())
    plans = (FaultPlan.from_spec("server/queue/lease:kill,times=1"),
             None, None)
    with mesh_trio(tmp, "queue", device, fault_plans=plans) as (svcs, urls):
        n0 = smoke.kernel_launches()
        t0 = time.perf_counter()
        res = Session(device=device, backend=QueueBackend(
            client=_client(urls), chunk_size=2, poll_seconds=0.01)).run(study)
        wall = time.perf_counter() - t0
        launched = smoke.kernel_launches() - n0
        check(res.records == reference.records, "records diverged")
        check(svcs[0].dead, "the injected kill never fired")
        computed = res.stats["queue_cells_computed"]
        check(computed == cells, str(res.stats))
        adoptions = sum(s.counters["jobs_adopted_from_peers"]
                        for s in svcs[1:])
        check(adoptions == 1, f"{adoptions} job adoptions (want 1)")
        spread = _simulated(svcs)
        smoke.check_launches("job-adoption", launched,
                             sum(spread) + computed, device)
        _print_mesh("queue", svcs)
    print(f"mesh-smoke: job-adoption {wall:.1f}s — enqueuing "
          f"daemon killed on first lease, sibling adopted the job from "
          f"its replica, worker drained {cells}/{cells} cells, records "
          f"bit-identical")
    return {"wall_s": wall, "cells": cells, "worker_cells": computed,
            "adoptions": adoptions, "simulated": spread,
            "launches": launched, "records": res.records}


def run(device="cuda", reference=None) -> dict:
    """Every scenario on `device`; `reference` is the in-process records of
    the SMALL study (computed here on `device` when not given). Returns
    each scenario's numbers by name."""
    if reference is None:
        reference = api.Session(device=device).run(_study(seeds=(0, 1)))
    print(f"mesh-smoke: reference study in-process, "
          f"{len(reference.records)} records; replication={REPLICATION}")
    with tempfile.TemporaryDirectory(prefix="warpsim-mesh-smoke-") as tmp:
        out = {"cold_warm": scenario_cold_then_warm(reference, tmp, device),
               "owner_kill": scenario_owner_killed_mid_study(
                   reference, tmp, device),
               "job_adoption": scenario_queue_job_adoption(
                   reference, tmp, device)}
    print("mesh-smoke OK")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.benchmarks.mesh_smoke",
        description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="the daemons' and this process's device: cuda "
                         "(default) or cpu")
    run(ap.parse_args(argv).device)


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as e:
        sys.exit(f"mesh-smoke: FAIL: {e}")
