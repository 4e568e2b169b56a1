"""How ``correct`` is decided: a sample of the window's cells, one drawn
from the seed in each stratum (a machine at a thread count and at each
value of the fields the traffic varies within a step, which together set
a K2 launch's placement), with the longest cell in it, each worked out
again by the plain reference and compared with what the program returned
and what its ResultCache holds, field for field. Exact: the limit of
each number is 0.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Hashable, List, Sequence, Tuple

import numpy as np

from warpbench import reference

#: Each compared number's limit (exact comparisons).
LIMITS = {"records_differing": 0, "cycles_max_rel_gap": 0.0}


@dataclasses.dataclass(frozen=True)
class Done:
    """One cell the window finished: its coordinates, its machine's
    fields, the program's record and the ResultCache's entry."""

    bench: str
    n_threads: int
    seed: int
    machine: Dict
    record: Dict
    cached: Dict


def pick(strata: Sequence[Hashable], cycles: Sequence[float],
         seed: int) -> List[int]:
    """Indices of one of the window's cells in each stratum (cell `i` lies
    in `strata[i]` and took `cycles[i]`), drawn from `seed`, and of the
    cell with the most cycles."""
    order = np.random.default_rng([seed % (1 << 64), 2]).permutation(
        len(cycles))
    first: Dict[Hashable, int] = {}
    for i in order.tolist():
        first.setdefault(strata[i], i)
    chosen = set(first.values())
    if len(cycles):
        chosen.add(int(np.argmax(cycles)))
    return sorted(chosen)


def _gap(a, b) -> float:
    """|a - b| / |b|; 1 where `a` is missing or not a number."""
    if not isinstance(a, float) or not math.isfinite(a):
        return 1.0
    return abs(a - b) / abs(b) if a != b else 0.0


def compare(done: Sequence[Done]) -> Tuple[Dict[str, float], List]:
    """The compared numbers over `done`, against the reference, and the
    first differences found (for the log)."""
    refs = reference.records(
        [(d.bench, d.n_threads, d.seed, d.machine) for d in done])
    differing, worst, diffs = 0, 0.0, []
    for d, want in zip(done, refs):
        bad = False
        for got in (d.record, d.cached):
            if got != want:
                bad = True
                if len(diffs) < 4:
                    diffs.append((d.bench, d.machine["name"], d.seed,
                                  {k: (got.get(k) if got else None, want[k])
                                   for k in want
                                   if not got or got.get(k) != want[k]}))
            worst = max(worst, _gap(got.get("cycles") if got else None,
                                    want["cycles"]))
        differing += bad
    return {"records_differing": differing,
            "cycles_max_rel_gap": worst}, diffs


def verdict(numbers: Dict[str, float]) -> bool:
    return all(numbers[k] <= LIMITS[k] for k in LIMITS)


def lines(numbers: Dict[str, float]) -> Dict[str, Dict]:
    """The result line's ``checks``: each number beside its limit."""
    return {k: {"value": numbers[k], "limit": LIMITS[k]} for k in LIMITS}
