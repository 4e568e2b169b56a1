"""K2's work, counted from the units' warp-op streams as the timing model
defines them (not from K2's arguments or marshalled columns), and the
card's peak it is held against.

K2 runs each unit of a family launch as one dependent chain of steps, one
step a warp-op, so a launch lasts as long as its longest unit. Its least
traffic is each unit's op records and block entries read once and its
result written once: an op record is the op's issue cycles, kind and
block slice (8 + 1 + 8 + 8 bytes), a block entry its id and touched
bytes (8 + 8), a warp its op range (8 + 8), a result the unit's cycles and
three counts (4 x 8).
"""

from __future__ import annotations

from typing import Iterable, Tuple

#: HBM3 bandwidth of one NVIDIA H100 SXM (NVIDIA's data sheet), bytes/s.
PEAK_BYTES_PER_S = 3.35e12

OP_BYTES = 8 + 1 + 8 + 8
BLOCK_BYTES = 8 + 8
WARP_BYTES = 8 + 8
RESULT_BYTES = 4 * 8


def unit(n_ops: int, n_blocks: int, n_warps: int) -> Tuple[int, int]:
    """``(steps, bytes)`` of one unit."""
    return n_ops, (OP_BYTES * n_ops + BLOCK_BYTES * n_blocks
                   + WARP_BYTES * n_warps + RESULT_BYTES)


def family(units: Iterable[Tuple[int, int, int]]) -> Tuple[int, int]:
    """``(steps of the longest unit, bytes of all units)`` of one launch,
    from each unit's ``(n_ops, n_blocks, n_warps)``."""
    steps = total = 0
    for n_ops, n_blocks, n_warps in units:
        s, b = unit(n_ops, n_blocks, n_warps)
        steps, total = max(steps, s), total + b
    return steps, total
