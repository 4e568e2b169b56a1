"""Carry-over from the reference: numpy WarpStream columns -> the port's.

The system runs no model, so its "weights" are the inputs of the family
launch. :func:`stream_from_arrays` takes the columns of a WarpStream as
plain numpy arrays (for example ``{f: getattr(ref_stream, f) for f in
FIELDS}`` of the reference package's stream) and returns the port's
:class:`~repro_torch.core.warpsim.divergence.WarpStream`, so a test can
feed the port's kernels exactly the reference's stream and tell a
host-stage difference from a kernel difference.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.core.warpsim import _cuda
from repro_torch.core.warpsim.divergence import WarpStream

#: The WarpStream array columns, in declaration order.
FIELDS = ("warp", "issue", "tins", "lanes", "kind", "maccs", "blk_off",
          "blk_len", "blocks", "nbytes", "op_start")


def stream_from_arrays(cols: Dict[str, np.ndarray]) -> WarpStream:
    """Validate `cols` and build a WarpStream from them.

    Integer columns are taken as int64 and ``kind`` as int8; ``n_warps``
    is ``len(op_start) - 1``. Raises ValueError on a missing column, a
    non-integer column, or offsets that do not index the columns.
    """
    missing = [f for f in FIELDS if f not in cols]
    if missing:
        raise ValueError(f"missing WarpStream columns: {missing}")
    arrs = {}
    for f in FIELDS:
        a = np.asarray(cols[f])
        if a.ndim != 1 or not np.issubdtype(a.dtype, np.integer):
            raise ValueError(f"column {f!r} must be a 1-D integer array, "
                             f"got {a.dtype} with shape {a.shape}")
        arrs[f] = np.ascontiguousarray(
            a, dtype=np.int8 if f == "kind" else np.int64)
    n_ops = len(arrs["issue"])
    for f in ("warp", "tins", "lanes", "maccs"):
        if len(arrs[f]) != n_ops:
            raise ValueError(f"column {f!r} has {len(arrs[f])} rows, "
                             f"expected {n_ops}")
    stream = WarpStream(n_warps=len(arrs["op_start"]) - 1, **arrs)
    _cuda.check_stream_cols(_cuda.stream_cols(stream))
    return stream
