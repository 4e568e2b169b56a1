"""The study's aggregation core, in C on the host.

Expansion phase 2 (``divergence.aggregate_stream``) replays a ThreadTrace
for one expansion key. The numpy pass does it one vectorised step per
event; this core (``csrc/warpsim_aggregate.c``) does the same walk in C,
faster, and gives the same columns bit for bit (all-integer arithmetic,
canonical sort orders). It runs on the host, where the trace lives, so
the study's host stages shrink while the card runs the family kernels.

The source is built at first use with ``cc -O2 -fPIC -shared
-ffp-contract=off -fno-fast-math`` into ``<repo>/build/repro_torch/``
(keyed by a hash of the source and flags) and bound through ctypes. A
failed build raises with the compiler's output: the study's path has no
fallback to the numpy pass, which stays as the plain version the tests
hold this core against.
"""

from __future__ import annotations

import ctypes
import shutil
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from repro_torch import _nvcc as build_mod

SOURCE = Path(__file__).resolve().parent / "csrc" / "warpsim_aggregate.c"
BUILD_DIR = build_mod.BUILD_DIR
CFLAGS = ("-O2", "-fPIC", "-shared", "-ffp-contract=off", "-fno-fast-math")

# The library, loaded once: the first of several threads (the sweep
# service's) builds and binds it while the others wait.
_LIB_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_LIB_PATH: Optional[str] = None


def find_cc() -> str:
    """Path of the system C compiler (``cc``, ``gcc`` or ``clang``); raises."""
    for name in ("cc", "gcc", "clang"):
        path = shutil.which(name)
        if path:
            return path
    raise RuntimeError("no C compiler (cc, gcc or clang) on PATH: the "
                       "aggregation core needs one")


_cc = find_cc


def build() -> str:
    """Build the core (once per source hash); returns the library's path.

    Raises RuntimeError with the compiler's output when the build fails.
    """
    return build_mod.build_shared(SOURCE, [], CFLAGS, BUILD_DIR, _cc,
                                  tool="cc")


def load() -> str:
    """Build (when needed) and load the core; returns the library's path.
    Raises RuntimeError with the compiler's output when the build fails."""
    _lib()
    return _LIB_PATH


def status() -> dict:
    """The core's report for the sweep service's ``/healthz`` (the
    counterpart of the reference's ``_native.status``): whether it is
    loaded, from which library, and the engine that aggregates
    (``native``: this core; nothing else aggregates on the study's path,
    so an unloaded core is ``unloaded``, never a fallback)."""
    loaded = _LIB is not None
    return {"loaded": loaded, "library": _LIB_PATH,
            "engine": "native" if loaded else "unloaded"}


def _lib() -> ctypes.CDLL:
    global _LIB, _LIB_PATH
    if _LIB is not None:
        return _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        path = build()
        lib = ctypes.CDLL(path)
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.warpsim_aggregate.argtypes = (
            [i64] * 6 + [i64, ptr, ptr, ptr, ptr] + [i64, ptr, ptr, ptr, ptr]
            + [i64] + [ptr] * 11)
        lib.warpsim_aggregate.restype = ctypes.c_int
        _LIB, _LIB_PATH = lib, path
    return _LIB


def run_aggregation(trace, cfg) -> Tuple[np.ndarray, ...]:
    """Run the C core over a ThreadTrace for one expansion key.

    Returns the WarpStream columns ``(warp, issue, tins, kind, maccs,
    blk_off, blk_len, blocks, nbytes, op_start)``: ops grouped by warp in
    emission order within each warp, block pools in emission order.
    Raises RuntimeError if the build fails or the core runs out of memory.
    """
    lib = _lib()
    n = trace.n_threads
    ws = cfg.warp_size
    n_warps = n // ws
    tid_off, tid_cat = trace.tid_csr()

    # Output bounds: ops <= active warps per compute/mem event, blocks <=
    # pre-dedup transactions (= active threads) per mem event.
    active = np.diff(tid_off)
    ev_kind = np.ascontiguousarray(trace.ev_kind, dtype=np.int8)
    if len(ev_kind):
        ev_active = active[trace.ev_mask]
        ops_bound = int(np.minimum(ev_active, n_warps)[ev_kind <= 2].sum())
        blocks_bound = int(ev_active[(ev_kind == 1) | (ev_kind == 2)].sum())
    else:
        ops_bound = blocks_bound = 0

    ops = [np.empty(ops_bound, dtype=np.int8 if name == "kind" else np.int64)
           for name in ("warp", "issue", "tins", "kind", "maccs", "blk_off",
                        "blk_len")]
    o_blocks = np.empty(blocks_bound, dtype=np.int64)
    o_nbytes = np.empty(blocks_bound, dtype=np.int64)
    o_op_start = np.empty(n_warps + 1, dtype=np.int64)
    counts = np.zeros(2, dtype=np.int64)
    # Canonical inputs bound to locals for the call: the raw pointers must
    # not outlive their arrays.
    ins = (ev_kind, np.ascontiguousarray(trace.ev_mask, dtype=np.int32),
           *(np.ascontiguousarray(a, dtype=np.int64)
             for a in (trace.ev_arg, trace.ev_addr, tid_off, tid_cat,
                       trace.addr_off, trace.addr_vals)))
    code = lib.warpsim_aggregate(
        n, ws, cfg.simd_width, 1 if cfg.mimd else 0, cfg.transaction_bytes,
        cfg.issue_cycles_per_group,
        len(ev_kind), *(a.ctypes.data for a in ins[:4]),
        len(trace.masks), *(a.ctypes.data for a in ins[4:]),
        ops_bound, *(a.ctypes.data for a in ops),
        o_blocks.ctypes.data, o_nbytes.ctypes.data, o_op_start.ctypes.data,
        counts.ctypes.data)
    if code != 0:
        raise RuntimeError(f"warpsim_aggregate failed ({code}): out of "
                           f"memory for {ops_bound} ops")
    n_ops, n_blk = int(counts[0]), int(counts[1])
    # Copies, so the bound-sized buffers are not kept alive by the stream.
    return (*(a[:n_ops].copy() for a in ops), o_blocks[:n_blk].copy(),
            o_nbytes[:n_blk].copy(), o_op_start)
