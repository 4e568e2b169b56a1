"""Process start to the first timed study: imports, the kernel library
loaded, the warm-up grids (K2's placements, and the traces and streams a
traffic builds in set-up)."""


def read(run):
    return run.setup_s if run.setup_s > 0 else None
