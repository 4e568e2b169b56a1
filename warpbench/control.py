"""The readings that the limits of ``correct`` are set from, in one process:

    python3 -m warpbench.control --workload <cell> --seeds 1,2,3 [--seconds 1] [--faults]

For each seed, one run of the cell at its own sizes and load (set-up, a
window of ``--seconds``, the same sample a run checks), then three
readings of the compared numbers over that sample:

* ``program``: the program's records against the reference (the lower
  reading);
* ``control``: the reference with ties issued to the later warp, put in
  the program's place (it breaks the configuration's stated issue order);
* ``float32``: the reference in float32, the precision below the one the
  model states;
* with ``--faults``, for each fault of :mod:`warpbench.faults`: a run of
  its own with that fault planted under the timed path, the program's
  records against the reference.

Prints one JSON line a seed and a summary line with each reading's range.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)

from warpbench import check, faults, reference, spec  # noqa: E402
from warpbench.run import run_cell  # noqa: E402


def in_place(sample, **settings):
    """The compared numbers with the reference under `settings` put in the
    program's place, against the reference."""
    recs = reference.records(
        [(d.bench, d.n_threads, d.seed, d.machine) for d in sample],
        **settings)
    swapped = [dataclasses.replace(d, record=r, cached=r)
               for d, r in zip(sample, recs)]
    return check.compare(swapped)[0]


def readings(cell, seed: int, seconds: float, device: str,
             with_faults: bool = False) -> dict:
    t0 = time.perf_counter()
    _run, out, program, sample = run_cell(cell, seed, seconds, False, device)
    row = {"seed": seed, "cells": len(sample), "attempted": out["attempted"],
           "program": program,
           "control": in_place(sample, later_first=True),
           "float32": in_place(sample, ftype=np.float32)}
    for name in faults.FAULTS if with_faults else ():
        with faults.planted(name):
            row[name] = run_cell(cell, seed, seconds, False, device)[2]
    row["seconds"] = time.perf_counter() - t0
    return row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m warpbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--faults", action="store_true")
    args = p.parse_args(argv)
    cell = spec.find_cell(args.workload)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        rows.append(readings(cell, seed, args.seconds, args.device,
                             args.faults))
        print(json.dumps(rows[-1]), flush=True)
    sides = ("program", "control", "float32") + (
        tuple(faults.FAULTS) if args.faults else ())
    summary = {
        side: {k: [min(r[side][k] for r in rows),
                   max(r[side][k] for r in rows)] for k in check.LIMITS}
        for side in sides}
    print(json.dumps({"workload": args.workload, "seeds": len(rows),
                      "ranges": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
