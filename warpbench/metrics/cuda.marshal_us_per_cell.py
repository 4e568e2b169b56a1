"""Host microseconds a window cell spent in ``_cuda.launch_family``: the
marshal and the rest of each family launch (host clock around the
calls, warpbench.stages)."""

from warpbench.stages import per_cell_us


def read(run):
    if run.stages is None:
        return None
    return per_cell_us(run.stages, ("marshal", "launch"), run.cells)
