"""Run the paper's warp-size study and print its headline table.

    PYTHONPATH=src python -m repro_torch.core.warpsim [--seeds 0,1,2]
    PYTHONPATH=src python -m repro_torch.core.warpsim --dense \\
        --cache-dir benchmarks/results/torch/sweep_cache
    PYTHONPATH=src python -m repro_torch.core.warpsim --device cpu

Prints the expansion sharing plan, the run's cache counters, the paper's
headline table and, with ``--dense``, the geomean IPC of the dense 4..128
warp-size sweep. With ``--cache-dir`` every cell (and, as ``.npz``
snapshots under ``traces/``, every ThreadTrace) is kept on disk, so a
second run simulates nothing. The study runs on the card (the family
kernels) unless ``--device cpu`` asks for the plain PyTorch versions.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.core.warpsim import api, machines, runner


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.core.warpsim",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels, default) or cpu")
    ap.add_argument("--seeds", default="0",
                    help="comma-separated workload seeds (default 0)")
    ap.add_argument("--dense", action="store_true",
                    help="also run the dense 4..128 warp-size sweep")
    ap.add_argument("--cache-dir", default=None,
                    help="on-disk cell and trace cache (default: none)")
    args = ap.parse_args(argv)
    seeds = tuple(int(s) for s in args.seeds.split(","))
    dev = torch.device(args.device)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    session = api.Session(device=dev, cache_dir=args.cache_dir,
                          persist_traces=args.cache_dir is not None)
    suite = machines.paper_suite()
    print(f"15 benchmarks x {len(suite)} machines x seeds {list(seeds)} on "
          f"{name}")
    print(f"  {machines.sharing_plan(suite)}")
    for ekey, names in machines.expansion_groups(suite).items():
        if len(names) > 1:
            print(f"  {'+'.join(names)} share one expansion "
                  f"(warp={ekey[0]}, simd={ekey[1]})")
    t0 = time.perf_counter()
    res = session.run(api.Study(seeds=seeds))
    wall = time.perf_counter() - t0
    st = res.stats
    print(f"  {len(res)} cells in {wall:.3f} s ({st['cache_hits']} cached, "
          f"{st['simulated']} simulated, {st['expansion_groups']} "
          f"aggregations from {st['trace_families']} thread traces, "
          f"{st['family_launches']} family launches)")
    print(f"  trace cache: {st['trace_cache_hits']} hits / "
          f"{st['trace_cache_misses']} misses ({st['trace_disk_hits']} from "
          f"disk); expansion LRU: {st['expansion_cache_hits']} hits / "
          f"{st['expansion_cache_misses']} misses")
    print("headline (mean [min, max] over seeds):")
    for metric, value in res.bands().items():
        print(f"  {metric:40s} {value['mean']:.4f}  "
              f"[{value['min']:.4f}, {value['max']:.4f}]")
    if args.dense:
        t0 = time.perf_counter()
        dres = session.run(api.Study.warp_size_range(4, 128))
        print(f"dense warp-size sweep, 4..128 threads/warp: {len(dres)} "
              f"cells in {time.perf_counter() - t0:.3f} s "
              f"({dres.stats['cache_hits']} cached, "
              f"{dres.stats['family_launches']} family launches)")
        for m in dres.machines:
            print(f"  {m:6s} geomean IPC "
                  f"{runner.mean_ipc(dres.per_bench(m)):6.3f}")


if __name__ == "__main__":
    main()
