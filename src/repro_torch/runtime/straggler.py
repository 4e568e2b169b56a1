"""Straggler detection: per-step wall-time monitor with robust outlier
flagging.

The port of ``repro.runtime.straggler``, copied: the same events for the
same durations. The training driver ends a step's clock after the loss
has reached the host (``float(loss)``), which on a card waits for the
step's kernels, as the reference's ``float(metrics["loss"])`` waits for
its device.

At datacenter scale the common failure mode is not a crash but a *slow*
host (thermal throttling, failing HBM, noisy neighbor). The monitor keeps
a rolling window of step times and flags steps exceeding
``median + k * MAD`` (median absolute deviation — robust to the skewed
step-time distribution). On real deployments the flag feeds the elastic
controller (the reference's ``runtime/elastic.py``, not ported yet) which
can evict the slow host and re-mesh; here the policy hook is a callback.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Deque, List, Optional


@dataclasses.dataclass
class StragglerEvent:
    step: int
    duration_s: float
    median_s: float
    mad_s: float


class StragglerMonitor:
    def __init__(self, window: int = 50, k: float = 6.0, min_samples: int = 10,
                 on_straggler: Optional[Callable[[StragglerEvent], None]] = None):
        self.window: Deque[float] = collections.deque(maxlen=window)
        self.k = k
        self.min_samples = min_samples
        self.on_straggler = on_straggler
        self.events: List[StragglerEvent] = []
        self._t0: Optional[float] = None

    def start_step(self) -> None:
        self._t0 = time.perf_counter()

    def end_step(self, step: int) -> Optional[StragglerEvent]:
        assert self._t0 is not None, "start_step not called"
        dur = time.perf_counter() - self._t0
        self._t0 = None
        ev = self.observe(step, dur)
        return ev

    def observe(self, step: int, duration_s: float) -> Optional[StragglerEvent]:
        """Feed one step duration; returns an event if it is an outlier."""
        ev = None
        if len(self.window) >= self.min_samples:
            med = _median(self.window)
            mad = _median([abs(x - med) for x in self.window]) or 1e-9
            if duration_s > med + self.k * mad:
                ev = StragglerEvent(step, duration_s, med, mad)
                self.events.append(ev)
                if self.on_straggler:
                    self.on_straggler(ev)
        self.window.append(duration_s)
        return ev


def _median(xs) -> float:
    s = sorted(xs)
    n = len(s)
    if n == 0:
        return 0.0
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])
