"""K2's device time over the window's launches, in nanoseconds, divided by
the sum over those launches of their longest unit's steps (warp-ops in
that unit's stream, warpbench.k2work)."""


def read(run):
    if not run.device or not run.launches or run.device["k2_s"] <= 0:
        return None
    steps = sum(s for s, _ in run.launches)
    return 1e9 * run.device["k2_s"] / steps if steps else None
