"""Share of the traced window in which no kernel, copy or set ran on the
card (torch.profiler's trace, warpbench.devtrace)."""


def read(run):
    if not run.device or run.device["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.device["busy_s"] / run.device["window_s"])
