"""Facade parity of the port: the three backends give the same records.

One quick grid (BFS, DYN x ws8, SW+, ws16 x seeds 0-1, 128 threads: 12
cells) runs through every :class:`repro_torch.core.warpsim.api.Backend`:

1. ``QueueBackend`` against a freshly booted daemon — the grid is sharded
   onto the lease-based work queue and drained by this process as a
   worker on `--device` (it must have computed every cell: the daemon is
   cold);
2. ``ServiceBackend`` against the same daemon — served from its cache,
   with zero new simulations;
3. ``InProcessBackend`` in a fresh :class:`~repro_torch.core.warpsim.api.
   Session` on `--device` over a throwaway cache dir — a cold local run,
   one family launch per trace family on the card.

Every record (coordinates and every ``SimResult`` field) must be equal
across the three, and equal to the reference's records of the grid in
``src/repro_torch/core/warpsim/data/facade_grid_seeds01.json`` (floats
as ``float.hex()``). Exit code 0 iff every check holds::

    PYTHONPATH=src python -m repro_torch.benchmarks.facade_parity \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile
import time
from pathlib import Path

from repro_torch.benchmarks.service_smoke import (
    SmokeFailure, _get, boot_daemon, check,
)
from repro_torch.core.warpsim import api, machines

GRID_FILE = (Path(__file__).resolve().parents[1] / "core" / "warpsim"
             / "data" / "facade_grid_seeds01.json")


def study() -> api.Study:
    """The parity grid (the reference harness's)."""
    return api.Study(
        benches=("BFS", "DYN"),
        machines={"ws8": machines.baseline(8), "SW+": machines.sw_plus(),
                  "ws16": machines.baseline(16)},
        n_threads=128, seeds=(0, 1))


def encode_record(rec: api.RunRecord) -> dict:
    """A record in the data file's form: floats as ``float.hex()``."""
    return {"machine": rec.machine, "bench": rec.bench, "seed": rec.seed,
            "n_threads": rec.n_threads,
            "result": {k: (v.hex() if isinstance(v, float) else v)
                       for k, v in dataclasses.asdict(rec.result).items()}}


def reference_records() -> list:
    with open(GRID_FILE, encoding="utf-8") as fh:
        return json.load(fh)["records"]


def run_backends(url: str, device: str) -> dict:
    """The grid through the three backends against the (cold) daemon at
    `url`; returns ``{backend: (StudyResult, wall seconds)}`` after
    checking the counts each backend must show."""
    st = study()
    n_cells = len(st.cells())
    out = {}

    t0 = time.perf_counter()
    queue_res = api.Session(device=device, backend=api.QueueBackend(
        url, chunk_size=2)).run(st)
    out["queue"] = (queue_res, time.perf_counter() - t0)
    check(len(queue_res) == n_cells
          and queue_res.stats["queue_cells_computed"] == n_cells,
          f"queue backend: {queue_res.stats}")

    sim_before = _get(url + "/stats")["counters"]["simulated"]
    t0 = time.perf_counter()
    service_res = api.Session(device=device,
                              backend=api.ServiceBackend(url)).run(st)
    out["service"] = (service_res, time.perf_counter() - t0)
    sim_after = _get(url + "/stats")["counters"]["simulated"]
    check(len(service_res) == n_cells and sim_after == sim_before,
          f"service backend re-simulated {sim_after - sim_before} cells")

    with tempfile.TemporaryDirectory(prefix="warpsim-facade-") as local:
        t0 = time.perf_counter()
        inproc_res = api.Session(device=device, cache_dir=local).run(st)
        out["inprocess"] = (inproc_res, time.perf_counter() - t0)
    n_families = len(st.benches) * len(st.seeds)
    check(inproc_res.stats["simulated"] == n_cells
          and inproc_res.stats["family_launches"] == n_families,
          f"in-process backend: {inproc_res.stats}")

    want = reference_records()
    for name, (res, _wall) in out.items():
        got = [encode_record(r) for r in res.records]
        check(got == want, f"{name} backend's records differ from the "
                           f"reference's ({GRID_FILE.name})")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.benchmarks.facade_parity",
        description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, for the daemon and this "
                         "process")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="warpsim-facade-") as tmp, \
            boot_daemon(tmp, device=args.device) as url:
        print(f"facade-parity: daemon at {url}, grid of "
              f"{len(study().cells())} cells on {args.device}")
        out = run_backends(url, args.device)
        for name, (res, wall) in out.items():
            print(f"facade-parity: {name:9s} {wall:.3f} s, stats "
                  f"{ {k: res.stats[k] for k in ('cells', 'simulated')} }")
    print(f"facade-parity: {len(study().cells())} records bit-identical "
          f"across queue / service / inprocess and the reference's file")
    print("facade-parity OK")


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as e:
        sys.exit(f"facade-parity: FAIL: {e}")
