"""K2 launches running beside each K2 launch, on average: the program's
``warpsim_k2_beside`` histogram (at each K2 launch, the earlier K2
launches on other streams whose results were not in yet), its sum over
its count. Read from the process's totals, warm-up launches included, as
warpbench.obsread reads K2's time; None without the histogram (a program
older than it, or one run without a card)."""

import sys

from warpbench import obsread


def read(run):
    obs = sys.modules.get(obsread.OBS_MODULE)
    if obs is None:
        return None
    beside = obs.default().registry.snapshot().get("warpsim_k2_beside", {})
    count = beside.get(".count")
    return beside[".sum"] / count if count else None
