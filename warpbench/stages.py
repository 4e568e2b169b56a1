"""Host-clock spans of the study's layers, and K2's work per launch.

Both wrap the program's functions where the sweep looks them up, for the
length of a ``with`` block, and restore them after it.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

from warpbench import k2work

#: The host stages of a study, in the order a family passes them.
HOST_STAGES = ("trace", "aggregate", "marshal", "launch", "wait")


@contextlib.contextmanager
def stage_timers(sweep_mod, cuda_mod, annotate: Optional[type] = None):
    """Within the block, sum the host-clock seconds of the study's host
    stages (the dict it yields): the trace builds and aggregations the
    sweep calls, the marshalling and the rest of each family launch (the
    enqueue), and the waits for a launch's results. `annotate`, when
    given (``torch.profiler.record_function``), also marks each call in
    the profiler's trace under its stage's name."""
    secs = dict.fromkeys(HOST_STAGES, 0.0)
    targets = {"trace": (sweep_mod, "build_thread_trace"),
               "aggregate": (sweep_mod, "aggregate_stream"),
               "marshal": (cuda_mod, "marshal"),
               "launch": (cuda_mod, "launch_family"),
               "wait": (cuda_mod, "collect")}
    saved = {k: getattr(m, n) for k, (m, n) in targets.items()}

    def timed(key, fn):
        def call(*args, **kw):
            span = (annotate(key) if annotate is not None
                    else contextlib.nullcontext())
            with span:
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kw)
                finally:
                    secs[key] += time.perf_counter() - t0
        return call
    for key, (mod, name) in targets.items():
        setattr(mod, name, timed(key, saved[key]))
    try:
        yield secs
    finally:
        for key, (mod, name) in targets.items():
            setattr(mod, name, saved[key])
        secs["launch"] -= secs["marshal"]   # marshal runs inside the launch


@contextlib.contextmanager
def launch_work(cuda_mod):
    """Within the block, record K2's work for each family launch (the list
    it yields): ``(steps of its longest unit, least bytes)`` from the
    units' streams, as :mod:`warpbench.k2work` counts them."""
    work: List[Tuple[int, int]] = []
    saved = cuda_mod.launch_family

    def call(pairs, *args, **kw):
        work.append(k2work.family(
            (len(stream.issue), len(stream.blocks), int(stream.n_warps))
            for stream, _cfg in pairs))
        return saved(pairs, *args, **kw)
    cuda_mod.launch_family = call
    try:
        yield work
    finally:
        cuda_mod.launch_family = saved


def per_cell_us(secs: Dict[str, float], keys, cells: int) -> Optional[float]:
    """Microseconds a cell the stages `keys` took together, None without
    cells."""
    if cells <= 0:
        return None
    return 1e6 * sum(secs[k] for k in keys) / cells
