"""Memory-access generation and coalescing models.

Baseline coalescing follows compute-capability-2.0 semantics (paper §2):
the accesses of all threads in one warp instruction are merged into the set
of unique 64 B aligned segments they touch — one memory transaction per
segment. Aggregation never crosses a warp boundary.

SW+ "ideal coalescing" (paper §4.1) extends merging across *all* threads of
an SM: a read that targets a 64 B block with an outstanding request merges
into it and issues no new off-core transaction. That part is stateful (it
depends on what is in flight) and lives in the family kernel's outstanding
table (``csrc/warpsim_family.cuh``); write accesses never merge (paper §7).
"""

from __future__ import annotations

import functools
import zlib

import numpy as np

from repro_torch.core.warpsim.trace import Mem

# Address-space layout: each statement instance gets a disjoint base region
# derived from its uid so different arrays never false-share blocks.
_REGION_BITS = 28          # 256 MB per statement region
_WORD = 4                  # 32-bit words (paper: 16-word coalescing width)


@functools.lru_cache(maxsize=8)
def _tid_range(n: int) -> np.ndarray:
    """Shared thread-id ramp (callers never mutate it)."""
    return np.arange(n, dtype=np.int64)


@functools.lru_cache(maxsize=8)
def _zero_offsets(n: int) -> np.ndarray:
    """Shared all-zero offset vector (callers never mutate it)."""
    return np.zeros(n, dtype=np.int64)


def generate_addresses(
    stmt: Mem, uid: int, n_threads: int, rng: np.random.Generator
) -> np.ndarray:
    """Byte addresses accessed by every thread for one memory instruction.

    Statements with a ``region`` name share one base address across all
    their dynamic instances (temporal reuse across loop iterations, and
    inter-warp block sharing for stencil halos / shared tables); anonymous
    statements get a fresh region per instance.
    """
    if stmt.region is not None:
        # Stable across processes (unlike built-in str hashing, which is
        # salted per interpreter) — required for cross-process result
        # caching and parallel sweep workers to agree bit-for-bit.
        region_id = zlib.crc32(stmt.region.encode()) % (1 << 20)
    else:
        region_id = (1 << 20) + uid
    base = np.int64(region_id) << _REGION_BITS
    tid = _tid_range(n_threads)
    ws = max(int(stmt.working_set), _WORD * n_threads)

    if stmt.pattern == "coalesced":
        off = tid * _WORD
    elif stmt.pattern == "strided":
        off = tid * np.int64(stmt.stride)
    elif stmt.pattern == "random":
        off = rng.integers(0, ws, n_threads, dtype=np.int64)
    elif stmt.pattern == "broadcast":
        off = _zero_offsets(n_threads)
    else:
        raise ValueError(f"unknown pattern {stmt.pattern!r}")

    off = (off + np.int64(stmt.offset)) % ws
    if stmt.irregularity > 0.0:
        irr = rng.random(n_threads) < stmt.irregularity
        off = np.where(irr, rng.integers(0, ws, n_threads, dtype=np.int64), off)
    return base + off


def warp_transactions(addresses: np.ndarray, block_bytes: int = 64) -> np.ndarray:
    """CC-2.0 intra-warp coalescing: unique 64 B blocks touched.

    Returns the sorted unique block ids — one transaction each.
    """
    if addresses.size == 0:
        return addresses.astype(np.int64)
    return np.unique(addresses // block_bytes)


def warp_transactions_bytes(
    addresses: np.ndarray, block_bytes: int = 64
) -> tuple[np.ndarray, np.ndarray]:
    """Unique blocks + touched bytes per block (for partial-width stores)."""
    if addresses.size == 0:
        e = addresses.astype(np.int64)
        return e, e
    blocks, counts = np.unique(addresses // block_bytes, return_counts=True)
    nbytes = np.minimum(counts * _WORD, block_bytes)
    return blocks, nbytes
