"""K2's share of its roofline: the least time its launches could take
(each unit's op records and block entries read once, results written
once, at the card's HBM bandwidth; warpbench.k2work) over K2's device
time in the window."""

from warpbench import k2work


def read(run):
    if not run.device or not run.launches or run.device["k2_s"] <= 0:
        return None
    least = sum(b for _, b in run.launches) / k2work.PEAK_BYTES_PER_S
    return 100.0 * least / run.device["k2_s"]
