"""The plain reference of the warp-size study: each cell's record worked
out again from its inputs (benchmark, thread count, workload seed and the
machine's fields) in NumPy and Python, importing nothing of the program.

:func:`records` expands each workload once per expansion (warp size, SIMD
width, MIMD, transaction bytes) and runs the timing model for each cell.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Tuple

from warpbench.reference.expand import expand
from warpbench.reference.timing import simulate

#: The fields of a record, in the order the program's records give them.
FIELDS = ("name", "machine", "cycles", "thread_insns", "mem_insns",
          "offchip_requests", "merged_requests", "l1_hits", "idle_cycles",
          "busy_cycles", "simd_eff")


def expansion_of(m: Mapping) -> Tuple:
    return (m["warp_size"], m["simd_width"], bool(m["mimd"]),
            m["transaction_bytes"])


def records(cells: Iterable[Tuple[str, int, int, Mapping]], ftype=float,
            later_first: bool = False) -> List[Dict]:
    """The record of each cell ``(bench, n_threads, seed, machine)``, where
    `machine` holds every field of the machine and its ``name``
    (`ftype`, `later_first`: :func:`timing.simulate`'s)."""
    streams: Dict[Tuple, Dict] = {}
    out = []
    for bench, n_threads, seed, m in cells:
        key = (bench, n_threads, seed) + expansion_of(m)
        if key not in streams:
            streams[key] = expand(bench, n_threads, seed, *expansion_of(m))
        rec = {"name": bench, "machine": m["name"]}
        rec.update(simulate(streams[key], m, ftype, later_first))
        out.append(rec)
    return out
