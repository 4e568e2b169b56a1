"""Rescan rounds a step on K2's critical chains: the program's
``warpsim_k2_scan_rounds_total`` over ``warpsim_k2_steps_total``, each
summed over placements. A launch adds its longest unit's steps to the
one, and those steps times the unit's rounds of loads a step to the
other: ceil(warps / 256) above 256 warps, 0 at or below. Read from the
process's totals, warm-up launches included, as warpbench.obsread reads
K2's families; None without the counter (a program older than it, or
one run without a card)."""

import sys

from warpbench import obsread


def read(run):
    obs = sys.modules.get(obsread.OBS_MODULE)
    if obs is None:
        return None
    snap = obs.default().registry.snapshot()
    rounds = obsread.series(snap, "warpsim_k2_scan_rounds_total",
                            "placement")
    steps = obsread.series(snap, "warpsim_k2_steps_total", "placement")
    total = sum(v[0] for v in steps.values())
    if not rounds or not total:
        return None
    return sum(v[0] for v in rounds.values()) / total
