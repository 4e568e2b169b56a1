"""The study's host C cores: the aggregation core and the scheduling loop.

* ``csrc/warpsim_aggregate.c`` — expansion phase 2
  (``divergence.aggregate_stream``) replays a ThreadTrace for one
  expansion key. The numpy pass does it one vectorised step per event;
  this core does the same walk in C, faster, and gives the same columns
  bit for bit (all-integer arithmetic, canonical sort orders). It runs on
  the host, where the trace lives, so the study's host stages shrink
  while the card runs the family kernels.
* ``csrc/warpsim_loop.c`` — the timing model's scheduling loop
  (``warpsim_run``), the ``native`` engine of ``timing.simulate``: the
  ``fast`` engine's loop in C, operand for operand, on the host CPU.

Each source is built at first use with ``cc -O2 -fPIC -shared
-ffp-contract=off -fno-fast-math`` into ``<repo>/build/repro_torch/``
(keyed by a hash of the source and flags) and bound through ctypes. A
failed build raises with the compiler's output: there is no fallback to
the numpy pass or to the ``fast`` engine, which stay as the plain
versions the tests hold these cores against. Sweeps build both in the
parent before a process pool starts, so its workers only load them.
"""

from __future__ import annotations

import ctypes
import shutil
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from repro_torch import _nvcc as build_mod

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "warpsim_aggregate.c"
LOOP_SOURCE = CSRC / "warpsim_loop.c"
BUILD_DIR = build_mod.BUILD_DIR
CFLAGS = ("-O2", "-fPIC", "-shared", "-ffp-contract=off", "-fno-fast-math")

# The libraries, loaded once each: the first of several threads (the
# sweep service's) builds and binds one while the others wait.
_LIB_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_LIB_PATH: Optional[str] = None
_LOOP_LIB: Optional[ctypes.CDLL] = None
_LOOP_LIB_PATH: Optional[str] = None


def find_cc() -> str:
    """Path of the system C compiler (``cc``, ``gcc`` or ``clang``); raises."""
    for name in ("cc", "gcc", "clang"):
        path = shutil.which(name)
        if path:
            return path
    raise RuntimeError("no C compiler (cc, gcc or clang) on PATH: the "
                       "host C cores need one")


_cc = find_cc


def build() -> str:
    """Build the aggregation core (once per source hash); returns the
    library's path. Raises RuntimeError with the compiler's output when
    the build fails.
    """
    return build_mod.build_shared(SOURCE, [], CFLAGS, BUILD_DIR, _cc,
                                  tool="cc")


def build_loop() -> str:
    """Build the scheduling loop (once per source hash); returns the
    library's path. Raises RuntimeError with the compiler's output when
    the build fails.
    """
    return build_mod.build_shared(LOOP_SOURCE, [], CFLAGS, BUILD_DIR, _cc,
                                  tool="cc")


def load() -> str:
    """Build (when needed) and load the aggregation core; returns its
    path. Raises RuntimeError with the compiler's output when the build
    fails."""
    _lib()
    return _LIB_PATH


def load_loop() -> str:
    """Build (when needed) and load the scheduling loop; returns its path.
    Raises RuntimeError with the compiler's output when the build fails."""
    _loop_lib()
    return _LOOP_LIB_PATH


def available() -> bool:
    """True iff both cores build and load on this host (the first call
    builds them). A report for callers that ask: the engines never fall
    back on it, they raise."""
    try:
        load()
        load_loop()
    except (RuntimeError, OSError):
        return False
    return True


def status() -> dict:
    """The aggregation core's report for the sweep service's ``/healthz``
    (the counterpart of the reference's ``_native.status``): whether it
    is loaded, from which library, and the engine that aggregates
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


def _loop_lib() -> ctypes.CDLL:
    global _LOOP_LIB, _LOOP_LIB_PATH
    if _LOOP_LIB is not None:
        return _LOOP_LIB
    with _LIB_LOCK:
        if _LOOP_LIB is not None:
            return _LOOP_LIB
        path = build_loop()
        lib = ctypes.CDLL(path)
        ptr, i64, f64 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_double
        lib.warpsim_run.argtypes = ([i64] + [ptr] * 7 + [i64] * 5
                                    + [f64] * 4 + [ptr])
        lib.warpsim_run.restype = ctypes.c_int
        _LOOP_LIB, _LOOP_LIB_PATH = lib, path
    return _LOOP_LIB


def _canon(a, dtype) -> np.ndarray:
    if isinstance(a, np.ndarray) and a.dtype == dtype \
            and a.flags.c_contiguous:
        return a
    return np.ascontiguousarray(a, dtype=dtype)


def run_scheduling_loop(n_warps: int, op_start, issue, kind, blk_off,
                        blk_len, blocks, nbytes, cfg
                        ) -> Optional[Tuple[float, int, int, int]]:
    """Run the C scheduling loop over one stream's CSR columns on `cfg`.

    Returns ``(raw_cycles, offchip, merged, l1_hits)``, or None when the
    loop declines the machine as the reference's does (a geometry with
    no L1 set, controller or SM, or more blocks in flight on an SM than
    its fixed outstanding table holds): the caller then runs the ``fast``
    engine, whose tables are unbounded, and gets the same numbers.
    Raises RuntimeError if the build fails or the loop runs out of memory.
    """
    lib = _loop_lib()
    n_sets = cfg.l1_size_bytes // (cfg.transaction_bytes * cfg.l1_ways)
    if n_sets <= 0 or cfg.num_mem_ctrls <= 0 or cfg.num_sms <= 0:
        return None
    out = np.zeros(4, dtype=np.float64)
    # Canonical arrays bound to locals for the call: the raw pointers must
    # not outlive their arrays.
    arrs = (_canon(op_start, np.int64), _canon(issue, np.int64),
            _canon(kind, np.int8), _canon(blk_off, np.int64),
            _canon(blk_len, np.int64), _canon(blocks, np.int64),
            _canon(nbytes, np.int64))
    code = lib.warpsim_run(
        n_warps, *(a.ctypes.data for a in arrs),
        cfg.num_sms, cfg.num_mem_ctrls, n_sets, cfg.l1_ways,
        1 if cfg.ideal_coalescing else 0,
        float(cfg.dram_cycles_per_transaction),
        float(cfg.dram_latency_cycles),
        float(cfg.l1_hit_latency), float(cfg.pipeline_depth),
        out.ctypes.data)
    if code == 2:
        return None
    if code != 0:
        raise RuntimeError(f"warpsim_run failed ({code}): out of memory "
                           f"for {n_warps} warps")
    return float(out[0]), int(out[1]), int(out[2]), int(out[3])


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
