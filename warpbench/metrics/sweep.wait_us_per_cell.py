"""Host microseconds a window cell spent with the study loop blocked in
``_cuda.collect``, waiting for a launch: high when the card paces the
study (host clock around the calls, warpbench.stages)."""

from warpbench.stages import per_cell_us


def read(run):
    if run.stages is None:
        return None
    return per_cell_us(run.stages, ("wait",), run.cells)
