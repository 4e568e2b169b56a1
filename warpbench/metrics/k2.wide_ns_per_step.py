"""K2's device nanoseconds a step at widths over 256 warps a unit: what
``k2.ns_per_step`` computes (K2's device time in the window over the
launches' longest-unit steps, warpbench.k2work), read in the cells whose
units rescan their warps in memory."""

from warpbench import spec


def read(run):
    return spec.reader("k2.ns_per_step")(run)
