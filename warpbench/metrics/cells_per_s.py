"""Cells simulated over the window's wall time: every step started in the
window, the one in flight when the time was up included, with its time."""


def read(run):
    if run.window_s <= 0 or run.cells <= 0:
        return None
    return run.cells / run.window_s
