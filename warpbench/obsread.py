"""K2's device time a step by placement, from the program's own
measurements: the timing events ``repro_torch``'s ``_cuda`` records
around each K2 launch, observed into its observability registry as
``warpsim_k2_seconds{placement}`` and ``warpsim_k2_steps_total
{placement}``.

The registry holds the process's totals: a run's warm-up launches count
beside the window's, since the harness hands a reader no snapshot at the
window's edges. A benchmark run is one process, and K2's time a step does
not depend on the host, so the quotient is the window's to within the
few warm-up launches. A program without these families (one older than
them, or one run without a card) reads as None.
"""

from __future__ import annotations

import sys
from typing import Dict, Optional, Tuple

OBS_MODULE = "repro_torch.core.warpsim.obs"


def series(snap: Dict, metric: str, label: str) -> Dict[str, Tuple]:
    """``{label value: (sum, count)}`` of a histogram, ``{label value:
    (value,)}`` of a counter, from a registry snapshot
    (``MetricsRegistry.snapshot``)."""
    out: Dict[str, Tuple] = {}
    head = f'{{{label}="'
    for key, v in snap.get(metric, {}).items():
        if not key.startswith(head):
            continue
        name, _, field = key[len(head):].partition('"}')
        if field == ".sum":
            out[name] = (v, out.get(name, (0.0, 0))[1])
        elif field == ".count":
            out[name] = (out.get(name, (0.0, 0))[0], int(v))
        else:
            out[name] = (v,)
    return out


def k2_ns_per_step(placement: str) -> Optional[float]:
    """K2's device nanoseconds a step in `placement` over the process's
    launches: ``warpsim_k2_seconds`` over ``warpsim_k2_steps_total``.
    None without such a launch."""
    obs = sys.modules.get(OBS_MODULE)
    if obs is None:
        return None
    snap = obs.default().registry.snapshot()
    secs = series(snap, "warpsim_k2_seconds", "placement").get(placement)
    steps = series(snap, "warpsim_k2_steps_total", "placement").get(
        placement)
    if secs is None or steps is None or not steps[0] or not secs[1]:
        return None
    return 1e9 * secs[0] / steps[0]
