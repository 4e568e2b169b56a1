"""Benchmark harness entry point of the port: one function per paper
figure, plus the kernel, MoE-dispatch, roofline and sweep benches.

The port of ``benchmarks/run.py``. Prints ``name,us_per_call,derived``
CSV:

  PYTHONPATH=src python -m repro_torch.benchmarks.run            # everything
  PYTHONPATH=src python -m repro_torch.benchmarks.run --only fig7,moe
  PYTHONPATH=src python -m repro_torch.benchmarks.run --device cpu

``--only`` keeps the benches whose name holds one of its comma-separated
substrings: ``sweep`` (``sweep_bench``: the cold study against the
reference's host baselines, the warm grid, the launch contract),
``fig1``–``fig7`` (``figs.Figures`` over one
``api.Session.from_env``: a sweep daemon when one is named, else in
process over ``benchmarks/results/torch/sweep_cache``), ``kernels``
(``kernel_bench``), ``moe`` (``moe_dispatch_bench``) and ``roofline``
(``roofline_table``, the dry run's results). Every bench runs on the card
unless ``--device cpu`` asks for the plain versions; the roofline table
reads a file. The exit code is 1 if any bench raised; every traceback is
printed, and the benches after a failed one still run.
"""

from __future__ import annotations

import argparse
import sys
import traceback


def benches(device: str):
    """(name, function returning rows), in the reference's order."""
    from repro_torch.benchmarks import (figs, kernel_bench,
                                        moe_dispatch_bench, roofline_table,
                                        sweep_bench)
    from repro_torch.core.warpsim import api

    figures = None

    def fig(name):
        def rows():
            nonlocal figures
            if figures is None:
                figures = figs.Figures(api.Session.from_env(
                    cache_dir=figs.SWEEP_CACHE_DIR, device=device))
            return figures.figures()[name]()
        return rows

    return ([("sweep", lambda: sweep_bench.run(device=device))]
            + [(f"fig{i}", fig(f"fig{i}")) for i in range(1, 8)]
            + [("kernels", lambda: kernel_bench.run(device)),
               ("moe", lambda: moe_dispatch_bench.run(device)),
               ("roofline", roofline_table.run)])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.benchmarks.run")
    ap.add_argument("--only", default=None,
                    help="comma-separated substring filters")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    only = args.only.split(",") if args.only else None

    print("name,us_per_call,derived", flush=True)
    failures = 0
    for name, fn in benches(args.device):
        if only and not any(o in name for o in only):
            continue
        try:
            for row_name, us, derived in fn():
                print(f"{row_name},{us:.1f},{derived:.6g}", flush=True)
        except Exception:   # noqa: BLE001 — report all benches
            failures += 1
            traceback.print_exc()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
