"""K2's share of its roofline at widths over 256 warps a unit: what
``k2_roofline`` computes (the launches' least bytes, warpbench.k2work, at
the card's HBM bandwidth over K2's device time in the window), read in
the cells whose units rescan their warps in memory."""

from warpbench import spec


def read(run):
    return spec.reader("k2_roofline")(run)
