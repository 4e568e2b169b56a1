"""Observability smoke of the port: a two-daemon mesh study whose metrics
scrape and whose *trace* both check out end to end.

The port's counterpart of the reference's ``benchmarks/obs_smoke.py``,
with its checks and studies. Two in-process daemons on `--device` (the
card by default: each simulated cell one one-unit ``ws_family_kernel``
launch; ``--device cpu`` runs the kernel's plain version, engine
``torch``) over disjoint cache roots federate with replication=2; the
smoke runs a cold + warm study and a queue-backed study through them
and checks the two surfaces:

1. **metrics**: ``GET /metrics`` on every daemon parses as Prometheus
   text exposition (``obs.parse_exposition``);
   ``warpsim_cells_simulated_total`` summed over the fleet equals the
   study's cell count (ownership dedups across daemons); a warm re-study
   advances every monotonic sample without re-simulating anything.
2. **trace**: one study is ONE trace fleet-wide: merging the local span
   ring with every daemon's ``GET /debug/trace?id=`` dump yields a single
   rooted tree (every parent resolves) whose spans cover the client
   attempt, the serving daemon (``server/study``), the mesh hops
   (``server/peer/cell`` read-throughs and ``server/peer/replicate``
   pushes on the sibling), per-cell events, and, for the queue phase, the
   worker hops (``server/queue/lease`` / ``server/queue/complete`` on the
   daemon, ``worker.chunk`` in this process, whose worker computes on
   `--device`).

On the card each check also holds one launch a simulated cell (the delta
of this process's ``ws_family_kernel`` count against the fleet's
simulations plus the worker's cells) and none on a warm pass. Without a
card and without ``--device cpu`` it exits non-zero ("no CUDA device").
Exit code 0 iff every check holds::

    PYTHONPATH=src python -m repro_torch.benchmarks.obs_smoke [--device cpu]
"""

from __future__ import annotations

import argparse
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
from repro_torch.core.warpsim import obs as obs_mod
from repro_torch.core.warpsim.api import QueueBackend, ServiceBackend, Session
from repro_torch.core.warpsim.obs import parse_exposition
from repro_torch.core.warpsim.work_queue import _http_json, _http_text


def mesh_duo(tmp, device="cuda"):
    """Two meshed daemons on `device` over disjoint roots under `tmp`."""
    return smoke.mesh_fleet(tmp, "obs", 2, device)


def _scrape(url: str) -> dict:
    text = _http_text(url + "/metrics")
    check("# TYPE warpsim_cells_simulated_total counter" in text,
          "exposition is missing TYPE metadata")
    return parse_exposition(text)     # raises ValueError on malformed lines


def _fleet_spans(urls, tid):
    spans = []
    for url in urls:
        spans.extend(_http_json(url + "/debug/trace?id=" + tid)["spans"])
    return spans


def _assert_one_rooted_tree(spans, tid, root_name):
    """The merged dump is one trace: a single root, every parent
    resolvable — i.e. the study is fully reconstructable."""
    check(bool(spans), "no spans recorded")
    check({s["trace"] for s in spans} == {tid}, "trace forked")
    ids = {s["span"] for s in spans}
    roots = [s for s in spans if s["parent"] is None]
    check([s["name"] for s in roots] == [root_name], f"roots {roots}")
    dangling = [s for s in spans
                if s["parent"] is not None and s["parent"] not in ids]
    check(not dangling, f"unresolvable parents: {dangling[:3]}")


def check_metrics(reference, svcs, urls, study, device="cuda") -> dict:
    cells = len(study.cells())
    n0 = smoke.kernel_launches()
    t0 = time.perf_counter()
    res = Session(device=device, backend=ServiceBackend(
        client=_client(urls))).run(study)
    cold_s = time.perf_counter() - t0
    cold_launches = smoke.kernel_launches() - n0
    check(res.records == reference.records, "records diverged")
    cold = [_scrape(u) for u in urls]
    per = [int(m.get("warpsim_cells_simulated_total", 0)) for m in cold]
    total = sum(per)
    check(total == cells,
          f"{total} simulations in /metrics for {cells} cells fleet-wide")
    smoke.check_launches("metrics cold", cold_launches, total, device)
    # Warm re-study: every monotonic sample advances (or holds), the
    # request counters definitely advance, simulations do not.
    n0 = smoke.kernel_launches()
    t0 = time.perf_counter()
    warm_res = Session(device=device, backend=ServiceBackend(
        client=_client(urls))).run(study)
    warm_s = time.perf_counter() - t0
    warm_launches = smoke.kernel_launches() - n0
    check(warm_res.records == reference.records, "warm records diverged")
    warm = [_scrape(u) for u in urls]
    for before, after in zip(cold, warm):
        for key, value in before.items():
            if key.endswith(("_total", "_count")) or "_bucket{" in key:
                check(after.get(key, 0) >= value,
                      f"monotonic sample {key} went backwards")
    check(sum(m.get("warpsim_cells_simulated_total", 0)
              for m in warm) == total, "warm pass re-simulated")
    grew = sum(1 for b, a in zip(cold, warm)
               if a["warpsim_http_requests_total"]
               > b["warpsim_http_requests_total"])
    check(grew >= 1, "warm pass advanced no request counter")
    smoke.check_launches("metrics warm", warm_launches, 0, device)
    print(f"obs-smoke: metrics {cold_s + warm_s:.1f}s — exposition valid "
          f"on both daemons, {total} cells simulated once fleet-wide, "
          f"warm pass advanced monotonically with 0 re-simulations")
    return {"cold_s": cold_s, "warm_s": warm_s, "cells": cells,
            "simulated": per, "cold_launches": cold_launches,
            "warm_launches": warm_launches, "samples": len(warm[0]),
            "records": res.records}


def check_study_trace(reference, svcs, urls, study, device="cuda") -> dict:
    sims0 = sum(s.counters["simulated"] for s in svcs)
    n0 = smoke.kernel_launches()
    t0 = time.perf_counter()
    ob = obs_mod.default()
    with obs_mod.start_trace("obs-smoke", obs=ob) as ctx:
        tid = ctx.trace_id
        res = Session(device=device, backend=ServiceBackend(
            client=_client(urls))).run(study)
    wall = time.perf_counter() - t0
    smoke.check_launches(
        "study trace", smoke.kernel_launches() - n0,
        sum(s.counters["simulated"] for s in svcs) - sims0, device)
    check(res.records == reference.records, "records diverged")
    spans = ob.spans.dump(tid) + _fleet_spans(urls, tid)
    _assert_one_rooted_tree(spans, tid, "obs-smoke")
    names = {s["name"] for s in spans}
    check("client.attempt" in names, f"span names {names}")
    check("server/study" in names, f"span names {names}")
    # Mesh hops: the study was cold, so the serving daemon read-through
    # its sibling's cells (the sibling records server/peer/cell) and
    # every simulated cell was pushed to its replica (the receiver
    # records server/peer/replicate).
    check("server/peer/cell" in names, f"span names {names}")
    check("server/peer/replicate" in names, f"span names {names}")
    check(any(s["name"] == "cell" for s in spans), "no per-cell events")
    # Cross-process linkage: the daemon's study hop parents to a client
    # attempt span recorded locally.
    attempt_ids = {s["span"] for s in spans if s["name"] == "client.attempt"}
    study_hops = [s for s in spans if s["name"] == "server/study"]
    check(bool(study_hops) and all(s["parent"] in attempt_ids
                                   for s in study_hops),
          f"study hops {study_hops}")
    per_daemon = [len(_http_json(u + "/debug/trace?id=" + tid)["spans"])
                  for u in urls]
    print(f"obs-smoke: trace {wall:.1f}s — one trace {tid}, "
          f"{len(spans)} spans ({per_daemon} per daemon) merge into a "
          f"single rooted tree with peer forward+replicate hops")
    return {"wall_s": wall, "spans": len(spans), "per_daemon": per_daemon,
            "records": res.records}


def check_queue_trace(svcs, urls, study, device="cuda") -> dict:
    reference = api.Session(device=device).run(study)
    sims0 = sum(s.counters["simulated"] for s in svcs)
    n0 = smoke.kernel_launches()
    t0 = time.perf_counter()
    ob = obs_mod.default()
    with obs_mod.start_trace("obs-smoke-queue", obs=ob) as ctx:
        tid = ctx.trace_id
        res = Session(device=device, backend=QueueBackend(
            client=_client(urls), chunk_size=2, poll_seconds=0.01)).run(study)
    wall = time.perf_counter() - t0
    computed = res.stats["queue_cells_computed"]
    smoke.check_launches(
        "queue trace", smoke.kernel_launches() - n0,
        sum(s.counters["simulated"] for s in svcs) - sims0 + computed,
        device)
    check(res.records == reference.records, "queue records diverged")
    check(computed > 0, str(res.stats))
    spans = ob.spans.dump(tid) + _fleet_spans(urls, tid)
    _assert_one_rooted_tree(spans, tid, "obs-smoke-queue")
    names = {s["name"] for s in spans}
    # Worker hops: the local worker loop joins the job's trace per chunk
    # and every queue HTTP hop lands on the daemon under the same id.
    check("worker.chunk" in names, f"span names {names}")
    check("server/queue/lease" in names, f"span names {names}")
    check("server/queue/complete" in names, f"span names {names}")
    chunks = sum(1 for s in spans if s["name"] == "worker.chunk")
    print(f"obs-smoke: queue {wall:.1f}s — worker drained "
          f"{computed} cells over {chunks} "
          f"chunks, lease/complete hops all on trace {tid}")
    return {"wall_s": wall, "worker_cells": computed, "chunks": chunks,
            "spans": len(spans), "records": res.records}


def run(device="cuda", reference=None) -> dict:
    """Every check on `device`; `reference` is the in-process records of
    the SMALL study, seeds 0-1 (computed here on `device` when not given).
    Returns each check's numbers by name."""
    cold_study = _study(seeds=(0, 1))
    queue_study = _study(seeds=(2, 3))
    if reference is None:
        reference = api.Session(device=device).run(cold_study)
    print(f"obs-smoke: reference study in-process, "
          f"{len(reference.records)} records; replication={REPLICATION}")
    out = {}
    with tempfile.TemporaryDirectory(prefix="warpsim-obs-smoke-") as tmp:
        with mesh_duo(tmp, device) as (svcs, urls):
            out["metrics"] = check_metrics(reference, svcs, urls,
                                           cold_study, device)
        # Fresh roots for the trace phase so the study is cold again and
        # the peer forward/replicate hops actually happen on-trace.
        with mesh_duo(tmp + "/t", device) as (svcs, urls):
            out["trace"] = check_study_trace(reference, svcs, urls,
                                             cold_study, device)
            out["queue"] = check_queue_trace(svcs, urls, queue_study,
                                             device)
    print("obs-smoke OK")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.benchmarks.obs_smoke",
        description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="the daemons' and this process's device: cuda "
                         "(default) or cpu")
    run(ap.parse_args(argv).device)


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as e:
        sys.exit(f"obs-smoke: FAIL: {e}")
