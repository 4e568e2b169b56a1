"""``python3 -m warpbench --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``: one run of one cell (see :mod:`warpbench.run`)."""

import time

T_START = time.perf_counter()   # set-up is timed from here

import os  # noqa: E402
import sys  # noqa: E402

# The program under test lives in the checkout's src/.
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)

from warpbench.run import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
