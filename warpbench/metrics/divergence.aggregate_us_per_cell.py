"""Host microseconds a window cell spent aggregating streams
(``divergence.aggregate_stream``, the C core, as the sweep calls it; host
clock around the calls, warpbench.stages)."""

from warpbench.stages import per_cell_us


def read(run):
    if run.stages is None:
        return None
    return per_cell_us(run.stages, ("aggregate",), run.cells)
