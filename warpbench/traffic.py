"""The one traffic generator: a closed loop of steps, drawn from the seed.

A traffic file (``warpbench/traffic/<name>.json``) gives:

* ``workload_seeds``: ``"fresh"`` (every step at a workload seed of its
  own, never repeated in a run; the warm-up at another) or ``"fixed"``
  (every step and the warm-up at one workload seed);
* ``points``: machine fields, each with the values it takes; the steps
  walk their product once, in an order drawn from the seed. With none,
  every step is at the configuration's own machine, without end;
* ``per_step``: machine fields whose values all run within each step, one
  grid each, in an order drawn from the seed, so that every step does the
  same set of them; the check samples a cell of every machine at each of
  their values (:meth:`Traffic.stratum`);
* ``warmup``: the machine fields of each grid the set-up runs.

A step is a list of grids; a grid is the configuration's whole grid
(every benchmark on every machine) at one machine point.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterator, List, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Step:
    seed: int                           # the workload seed of its grids
    points: Tuple[Dict, ...]            # machine fields of each grid


def _entropy(seed: int) -> int:
    return seed % (1 << 64)


def workload_seed(seed: int, index: int) -> int:
    """The workload seed of step `index` (0: the warm-up) of a run."""
    state = np.random.SeedSequence([_entropy(seed), index]).generate_state(
        1, np.uint64)
    return int(state[0] >> np.uint64(2))


class Traffic:
    def __init__(self, params: Dict, seed: int):
        if params.get("loop", "closed") != "closed" \
                or params.get("clients", 1) != 1:
            raise ValueError("the generator drives one closed-loop client")
        self.params = params
        self.seed = seed
        self.fresh = params["workload_seeds"] == "fresh"
        if params["workload_seeds"] not in ("fresh", "fixed"):
            raise ValueError("workload_seeds is fresh or fixed")
        self._rng = np.random.default_rng([_entropy(seed), 1])

    def _seed(self, index: int) -> int:
        return workload_seed(self.seed, index if self.fresh else 0)

    def warmup(self) -> Step:
        return Step(self._seed(0),
                    tuple(dict(p) for p in self.params.get("warmup", [{}])))

    def _inner(self) -> List[Dict]:
        fields = self.params.get("per_step") or {}
        combos = [dict(zip(fields, vals))
                  for vals in itertools.product(*fields.values())]
        return [combos[i] for i in self._rng.permutation(len(combos))]

    def steps(self) -> Iterator[Step]:
        """The window's steps, in order (finite when ``points`` is set)."""
        fields = self.params.get("points") or {}
        if fields:
            combos = [dict(zip(fields, vals))
                      for vals in itertools.product(*fields.values())]
            outer = (combos[i] for i in self._rng.permutation(len(combos)))
        else:
            outer = itertools.repeat({})
        for index, point in enumerate(outer, start=1):
            yield Step(self._seed(index),
                       tuple({**point, **inner} for inner in self._inner()))

    def stratum(self, machine: Dict, n_threads: int) -> Tuple:
        """The check's stratum of a cell on `machine` (all its fields) at
        `n_threads`: the machine, the thread count and its values of the
        ``per_step`` fields."""
        return (machine["name"], n_threads) + tuple(
            machine[k] for k in sorted(self.params.get("per_step") or {}))
