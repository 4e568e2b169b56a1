"""K2's device nanoseconds a step in the ``shared`` placement: the
program's timing events around each launch (``warpsim_k2_seconds``) over
the launches' steps, each its longest unit's warp-ops
(``warpsim_k2_steps_total``); read as warpbench.obsread says."""

from warpbench import obsread


def read(run):
    return obsread.k2_ns_per_step("shared")
