"""Full warp-size study: every benchmark x machine, the paper's headline
claims, and a dense 4..128 warp-size scaling sweep — all driven through
the ``repro_torch.core.warpsim.api`` facade.

The port of ``examples/warpsize_study.py``. ``api.Session.from_env``
prefers a live sweep daemon named by ``WARPSIM_SERVICE_URL``
(``python -m repro_torch.core.warpsim.service``) and falls back to an
in-process session on ``--device`` over the on-disk cell cache
``--cache-dir``: each trace family is one K2 launch on the card (the
plain versions with ``--device cpu``). Re-running is near-instant: every
cell is served from the cache. The suite's records are saved as
``warpsim_suite.json`` beside the cache directory.

Run:  PYTHONPATH=src python -m repro_torch.examples.warpsize_study [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import time

from repro_torch.benchmarks.figs import SWEEP_CACHE_DIR
from repro_torch.core.warpsim import api, machines, obs, runner

#: The paper's headline ratios (Fig. 7, Secs. 6.2-6.3).
PAPER = {
    "swplus_over_lwplus": 1.11, "swplus_over_ws8": 1.16,
    "swplus_over_ws16": 1.12, "swplus_over_ws32": 1.19,
    "lwplus_over_ws8": 1.05, "lwplus_over_ws16": 1.01,
    "lwplus_over_ws32": 1.07, "lwplus_over_ws64": 1.15,
}


def print_obs_snapshot(session) -> None:
    """Where the time went, from the obs registry — the same store a
    daemon serves at ``GET /metrics``."""
    print("\nobservability (warpsim.obs registry snapshot):")
    stages = obs.default().registry.snapshot().get("warpsim_stage_seconds",
                                                   {})
    rows = sorted(label[:-len(".count")] for label in stages
                  if label.endswith(".count") and stages[label])
    for label in rows:
        n = int(stages[label + ".count"])
        total = stages[label + ".sum"]
        stage = (label[len('{stage="'):-len('"}')]
                 if label.startswith('{stage="') else label)
        print(f"  {stage:24s} {n:6d} x {1e3 * total / n:8.3f} ms "
              f"= {total:7.3f} s")
    if not rows:
        print("  (no local stages timed", end="")
        if isinstance(session.backend, api.ServiceBackend):
            print(f" — the daemon did the work; scrape "
                  f"{session.backend.url}/metrics for its histograms)")
        else:
            print(")")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--cache-dir", default=SWEEP_CACHE_DIR,
                    help="on-disk cell cache of an in-process session")
    args = ap.parse_args(argv)
    session = api.Session.from_env(cache_dir=args.cache_dir,
                                   persist_traces=True, device=args.device)
    if isinstance(session.backend, api.ServiceBackend):
        h = session.backend.client().healthz()
        print(f"using sweep service at {session.backend.url} "
              f"(engine={h['engine']}, model={h['model']})")

    print("running 15 benchmarks x 6 machines (paper Figs. 2-7)...")
    print(f"  {machines.sharing_plan(machines.paper_suite())}")
    for ekey, names in machines.expansion_groups(
            machines.paper_suite()).items():
        if len(names) > 1:
            print(f"  {'+'.join(names)} share one expansion "
                  f"(warp={ekey[0]}, simd={ekey[1]})")
    t0 = time.time()
    res = session.run(api.Study(machines=machines.paper_suite()))
    stats = res.stats
    print(f"  {len(res)} cells in {time.time() - t0:.2f}s "
          f"({stats['cache_hits']} cached, {stats['simulated']} simulated, "
          f"{stats['expansion_groups']} aggregations from "
          f"{stats['trace_families']} thread traces) "
          f"via the {res.backend} backend")
    print(f"  trace cache: {stats['trace_cache_hits']} hits / "
          f"{stats['trace_cache_misses']} misses "
          f"({stats['trace_disk_hits']} from disk, "
          f"{stats['traces_shared']} aggregations rode a "
          f"shared trace); expansion LRU: "
          f"{stats['expansion_cache_hits']} hits / "
          f"{stats['expansion_cache_misses']} misses")

    print(f"\n{'':6s}" + " ".join(f"{b:>6s}" for b in res.benches))
    for m in res.machines:
        per_b = res.per_bench(m)
        print(f"{m:6s}" + " ".join(f"{per_b[b].ipc:6.2f}"
                                   for b in res.benches))

    print("\nheadline comparisons (paper Fig. 7 / Secs. 6.2-6.3):")
    s = res.summary()
    for k, v in s.items():
        ref = PAPER.get(k)
        ref_s = f"(paper {ref:.2f})" if ref else ""
        print(f"  {k:40s} {v:6.3f} {ref_s}")

    print("\ndense warp-size scaling sweep, 4..128 threads/warp:")
    t0 = time.time()
    dres = session.run(api.Study.warp_size_range(4, 128))
    dstats = dres.stats
    print(f"  {len(dres)} cells in {time.time() - t0:.2f}s "
          f"(trace cache: {dstats['trace_cache_hits']}h/"
          f"{dstats['trace_cache_misses']}m, "
          f"{dstats['trace_disk_hits']} from disk)")
    for m in dres.machines:
        print(f"  {m:6s} geomean IPC "
              f"{runner.mean_ipc(dres.per_bench(m)):6.3f}")

    print_obs_snapshot(session)

    path = os.path.join(os.path.dirname(os.path.abspath(args.cache_dir)),
                        "warpsim_suite.json")
    runner.save_results(res.legacy_grid(), path)
    print(f"\nsaved {path}")
    return {"study": stats, "dense": dstats, "summary": s}


if __name__ == "__main__":
    main()
