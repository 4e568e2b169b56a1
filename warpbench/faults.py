"""Faults planted under the timed path, each of which a run has to come
out not correct for: wrappers of ``repro_torch.core.warpsim._cuda``'s
functions, by the name of the function each wraps.

* ``altered``: every answer altered where it is produced (a quarter cycle
  added to each unit's cycles);
* ``unchanged``: a launch that leaves its state as it was (every unit
  reads 0 cycles and 0 counts);
* ``half_left_out``: half of a launch's units left out, the rest's last
  result given in their place.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Tuple


def _altered(collect):
    def call(launch):
        return [(c + 0.25, o, m, h) for c, o, m, h in collect(launch)]
    return call


def _unchanged(collect):
    def call(launch):
        return [(0.0, 0, 0, 0) for _ in collect(launch)]
    return call


def _half_left_out(launch_family):
    import torch

    def call(pairs, *args, **kw):
        kept = list(pairs[:max(1, len(pairs) // 2)])
        out = launch_family(kept, *args, **kw)
        pad = len(pairs) - len(kept)
        out.cycles = torch.cat([out.cycles] + [out.cycles[-1:]] * pad)
        out.counts = torch.cat([out.counts] + [out.counts[-1:]] * pad)
        return out
    return call


#: fault -> (the ``_cuda`` function it wraps, the wrapper)
FAULTS: Dict[str, Tuple[str, Callable]] = {
    "altered": ("collect", _altered),
    "unchanged": ("collect", _unchanged),
    "half_left_out": ("launch_family", _half_left_out),
}


@contextlib.contextmanager
def planted(name: str):
    """Within the block, the program's timed path carries fault `name`."""
    from repro_torch.core.warpsim import _cuda
    where, wrap = FAULTS[name]
    saved = getattr(_cuda, where)
    setattr(_cuda, where, wrap(saved))
    try:
        yield
    finally:
        setattr(_cuda, where, saved)
