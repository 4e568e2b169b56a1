"""Warp-size sweep engine: one family launch per trace family.

A :class:`SweepSpec` is a declarative bench × machine × seed grid that
enumerates its cells in a fixed order (machines-major, benches, then
seeds). :func:`run_sweep_with_stats` runs it in two levels of sharing:

* **Trace families.** Expansion phase 1
  (:func:`~repro_torch.core.warpsim.divergence.build_thread_trace`) reads
  no machine field, so cells are bucketed by ``(bench, n_threads, seed)``
  and each family builds its ThreadTrace once.
* **Expansion keys.** Phase 2 (``aggregate_stream``) reads only
  :meth:`MachineConfig.expansion_key`, so within a family the cells are
  sub-bucketed by it and each key is aggregated once (SW+ rides on ws8's
  stream: 6 machines, 5 aggregations).

Then every (expansion key × machine) unit of the family is simulated in
ONE launch of the family kernels (:func:`_cuda.run_family`), and each
unit's loop output becomes a :class:`SimResult` through
:func:`~repro_torch.core.warpsim.timing.loop_result`.

Traces and streams live in dicts the caller owns (an
:class:`api.Session` keeps one pair per session); there is no on-disk
cache and no process pool.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

from repro_torch.core.warpsim import _cuda
from repro_torch.core.warpsim import machines as machines_mod
from repro_torch.core.warpsim.config import MachineConfig
from repro_torch.core.warpsim.divergence import (
    WarpStream, aggregate_stream, build_thread_trace,
)
from repro_torch.core.warpsim.timing import (
    SimResult, loop_result, stream_totals,
)
from repro_torch.core.warpsim.trace import (
    BENCHMARKS, ThreadTrace, get_workload,
)

# One grid cell: (machine name, machine config, bench, n_threads, seed).
Cell = Tuple[str, MachineConfig, str, Optional[int], int]


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """A declarative bench × machine × seed grid.

    `machines` maps display name -> :class:`MachineConfig`; when omitted the
    paper's suite (ws8/16/32/64, SW+, LW+) is used. Cells are enumerated
    machines-major, benches-minor, seeds-innermost.
    """

    benches: Tuple[str, ...] = tuple(BENCHMARKS)
    machines: Optional[Mapping[str, MachineConfig]] = None
    simd_width: int = 8
    n_threads: Optional[int] = None
    seeds: Tuple[int, ...] = (0,)

    def machine_set(self) -> Dict[str, MachineConfig]:
        if self.machines is not None:
            return dict(self.machines)
        return machines_mod.paper_suite(self.simd_width)

    def cells(self, machine_set: Optional[Mapping[str, MachineConfig]] = None
              ) -> List[Cell]:
        """Cell list in the spec's fixed order."""
        mset = self.machine_set() if machine_set is None else machine_set
        return [(mname, cfg, b, self.n_threads, seed)
                for mname, cfg in mset.items()
                for b in self.benches
                for seed in self.seeds]


def _families(cells: List[Cell]
              ) -> "collections.OrderedDict[tuple, collections.OrderedDict]":
    """``(bench, n_threads, seed) -> expansion key -> [cell]``, first-seen
    order at both levels."""
    families: "collections.OrderedDict[tuple, collections.OrderedDict]" = (
        collections.OrderedDict())
    for cell in cells:
        _mname, cfg, bench, n_threads, seed = cell
        fam = families.setdefault((bench, n_threads, seed),
                                  collections.OrderedDict())
        fam.setdefault(cfg.expansion_key(), []).append(cell)
    return families


def family_major_cells(cells: List[Cell]) -> List[Cell]:
    """Reorder cells family-major: trace family ``(bench, n_threads,
    seed)``, then expansion key within the family, preserving first-seen
    order of both."""
    return [cell for fam in _families(cells).values()
            for group in fam.values() for cell in group]


def run_sweep_with_stats(
    spec: SweepSpec,
    device="cuda",
    engine: str = "auto",
    traces: Optional[Dict[tuple, ThreadTrace]] = None,
    streams: Optional[Dict[tuple, WarpStream]] = None,
) -> Tuple[Dict[int, Dict[str, Dict[str, SimResult]]], Dict[str, int]]:
    """Run a sweep grid; returns ``(results, stats)``.

    ``results[seed][machine][bench] -> SimResult`` in the spec's order.
    `stats` counts ``cells``, ``simulated``, ``expansion_groups``,
    ``trace_families`` and ``family_launches`` (one per trace family).
    `traces` and `streams` are the caller's memo dicts, keyed
    ``(bench, n_threads, seed)`` and ``(bench, n_threads, seed,
    expansion_key)``; fresh ones are used when omitted.

    ``engine="cuda"`` (the family kernels) needs a CUDA `device`;
    ``engine="torch"`` (their plain versions) runs on the CPU.
    """
    engine = _cuda.resolve_engine(engine, device)
    traces = {} if traces is None else traces
    streams = {} if streams is None else streams
    mset = spec.machine_set()
    cells = spec.cells(machine_set=mset)
    families = _families(cells)
    results: Dict[int, Dict[str, Dict[str, SimResult]]] = {
        seed: {} for seed in spec.seeds}
    n_launches = 0
    for (bench, n_threads, seed), fam in families.items():
        wl = get_workload(bench, n_threads=n_threads, seed=seed)
        tkey = (wl.name, wl.n_threads, wl.seed)
        groups = []
        pairs = []
        for ekey, members in fam.items():
            skey = tkey + (ekey,)
            stream = streams.get(skey)
            if stream is None:
                trace = traces.get(tkey)
                if trace is None:
                    trace = traces[tkey] = build_thread_trace(wl)
                stream = streams[skey] = aggregate_stream(trace, members[0][1])
            groups.append((stream, members))
            pairs.extend((stream, cell[1]) for cell in members)
        raw = _cuda.run_family(pairs, device, engine)
        n_launches += 1
        i = 0
        for stream, members in groups:
            totals = stream_totals(stream)
            for mname, cfg, b, _n, s in members:
                results[s].setdefault(mname, {})[b] = loop_result(
                    wl.name, cfg, raw[i], totals)
                i += 1

    stats = dict(
        cells=len(cells),
        simulated=len(cells),
        expansion_groups=sum(len(fam) for fam in families.values()),
        trace_families=len(families),
        family_launches=n_launches,
    )
    ordered = {seed: {mname: {b: results[seed][mname][b]
                              for b in spec.benches}
                      for mname in mset}
               for seed in spec.seeds}
    return ordered, stats
