"""Reconvergence-stack divergence model and warp-op expansion.

Walks a kernel program over the *whole thread pool*, maintaining the
active-thread mask exactly as an immediate-post-dominator reconvergence
stack would (then-side executed, else-side executed, reconverge), and emits
per-warp macro-ops:

* SIMT machines: each side of a branch occupies full warp issue slots
  (``count × warp_size/simd_width`` cycles) regardless of how few lanes are
  active — that *is* the branch-divergence cost.
* MIMD machines (LW+): issue occupancy is proportional to *active* threads
  (``count × ceil(active/simd_width)``) — divergence costs nothing — but the
  warp remains a single schedulable unit that synchronizes at every
  macro-op boundary and waits for its slowest memory transaction, which is
  exactly the warp-wide synchronization overhead the paper charges LW+ for.

Branch outcomes and memory addresses are drawn once per *thread pool* from
the workload seed, so every machine model (any warp size, SW+, LW+)
executes the identical logical workload.

Expansion is a *two-phase* host pipeline (numpy; tensors start at the
family launch in :mod:`repro_torch.core.warpsim._cuda`):

1. :func:`build_thread_trace` walks the program once per ``(bench,
   n_threads, seed)`` and records everything drawn from the workload seed
   (branch-outcome masks, memory addresses, walk order) as a
   :class:`~repro_torch.core.warpsim.trace.ThreadTrace`. Nothing in the
   trace depends on the machine: MIMD fragment bookkeeping is deferred to
   phase 2 as SPLIT/RESET events.
2. :func:`aggregate_stream` replays the trace for one
   ``MachineConfig.expansion_key()`` (warp size, SIMD width, MIMD flag,
   transaction bytes) and emits the :class:`WarpStream` — per-warp issue
   occupancy and intra-warp (or per-fragment) coalescing — with one
   vectorized numpy pass per event.

:func:`expand_stream` composes the two phases; sweeps share one trace
across every expansion key of a workload.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.warpsim import coalesce
from repro_torch.core.warpsim.config import MachineConfig
from repro_torch.core.warpsim.trace import (
    TEV_COMPUTE, TEV_LOAD, TEV_RESET, TEV_SPLIT, TEV_STORE,
    Branch, Compute, Loop, Mem, Stmt, ThreadTrace, Workload,
    correlated_outcomes,
)

# WarpStream op kinds.
KIND_COMPUTE = 0
KIND_LOAD = 1
KIND_STORE = 2


@dataclasses.dataclass
class WarpStream:
    """Struct-of-arrays macro-op streams for all warps of one workload.

    Ops are stored grouped by warp (CSR layout: ops of warp ``w`` are rows
    ``op_start[w]:op_start[w+1]``) in program order within each warp. Memory
    ops reference contiguous slices ``blk_off[i]:blk_off[i]+blk_len[i]`` of
    the shared ``blocks`` / ``nbytes`` pools.
    """

    n_warps: int
    warp: np.ndarray       # int64[n_ops] owning warp
    issue: np.ndarray      # int64[n_ops] front-end occupancy
    tins: np.ndarray       # int64[n_ops] thread-instructions
    lanes: np.ndarray      # int64[n_ops] issued lane-slots
    kind: np.ndarray       # int8[n_ops]  KIND_COMPUTE / KIND_LOAD / KIND_STORE
    maccs: np.ndarray      # int64[n_ops] thread-level memory accesses
    blk_off: np.ndarray    # int64[n_ops] offset into blocks / nbytes
    blk_len: np.ndarray    # int64[n_ops] transactions of this op
    blocks: np.ndarray     # int64[n_blocks] 64 B block ids
    nbytes: np.ndarray     # int64[n_blocks] touched bytes per transaction
    op_start: np.ndarray   # int64[n_warps+1] CSR row offsets


def _grouped_transactions(keys, blocks: np.ndarray, block_bytes: int):
    """Per-group intra-warp coalescing, vectorized over the thread pool.

    `keys` are major-to-minor group key arrays — ``(warp,)`` for SIMT, or
    ``(warp, fragment)`` for MIMD where transactions never merge across
    never-reconverging fragments. Returns the major key per group (groups
    sorted ascending by the full key) with, per group, the sorted unique
    blocks and the bytes touched in each (the CC-2.0 semantics of
    :func:`coalesce.warp_transactions_bytes`, applied to every group in one
    lexsort + run-length dedup).
    """
    if len(keys) == 1:                   # SIMT: group by warp only
        k0 = keys[0]
        warp_step = k0[1:] != k0[:-1]    # k0 is non-decreasing (thread order)
        sorted_already = bool(
            (warp_step | (blocks[1:] >= blocks[:-1])).all())
        if sorted_already:
            # Coalesced / broadcast / monotone-strided accesses arrive
            # already in (warp, block) order — skip the sort entirely.
            sb = blocks
            changed = (sb[1:] != sb[:-1]) | warp_step
        elif int(blocks.max()) < (1 << 44) and \
                int(k0[-1] if len(k0) else 0) < (1 << 18):
            # Pack (warp, block) into one int64 and quicksort: ~2x faster
            # than lexsort, identical (warp, block) lexicographic order.
            # blocks fit 44 bits (region base < 2^48.1, >=32 B transactions)
            # and k0 is non-decreasing, so its max is its last element.
            comb = np.sort((k0 << np.int64(44)) | blocks)
            changed = comb[1:] != comb[:-1]
            k0 = comb >> np.int64(44)
            sb = comb & np.int64((1 << 44) - 1)
        else:
            order = np.lexsort((blocks, k0))
            k0 = k0[order]
            sb = blocks[order]
            changed = (sb[1:] != sb[:-1]) | (k0[1:] != k0[:-1])
    else:
        order = np.lexsort((blocks,) + tuple(reversed(keys)))
        sk = [k[order] for k in keys]
        k0 = sk[0]
        sb = blocks[order]
        changed = sb[1:] != sb[:-1]
        for k in sk:
            changed |= k[1:] != k[:-1]
    cut = np.nonzero(changed)[0]
    cut += 1
    idx = np.empty(len(cut) + 1, dtype=np.int64)
    idx[0] = 0
    idx[1:] = cut
    counts = np.empty(len(idx), dtype=np.int64)
    counts[:-1] = idx[1:] - idx[:-1]
    counts[-1] = len(sb) - idx[-1]
    nbytes = np.minimum(counts * coalesce._WORD, block_bytes)
    return k0[idx], sb[idx], nbytes


# ---------------------------------------------------------------------------
# Two-phase expansion: shared thread trace + per-key aggregation
# ---------------------------------------------------------------------------


def build_thread_trace(workload: Workload) -> ThreadTrace:
    """Phase 1: walk the program once, record everything seed-derived.

    Draws addresses at each executed memory instance and outcomes at each
    executed branch, in walk order, so the trace serves *every* machine
    config: masks are pure functions of the outcome stream, and a subtree
    is skipped (mask empty) independently of the machine.
    """
    n = workload.n_threads
    rng = np.random.default_rng(workload.seed)
    uid = [0]

    # Mask table: one row per unique mask object (straight-line runs and
    # loop bodies re-walk the same array; branch children are fresh rows).
    mask_rows: dict = {}
    mask_list: List[np.ndarray] = []
    tid_cache: dict = {}

    def row_of(mask: np.ndarray) -> int:
        r = mask_rows.get(id(mask))
        if r is None:
            r = len(mask_list)
            mask_list.append(mask)       # pins `mask`: id() never recycled
            mask_rows[id(mask)] = r
        return r

    ev_kind: List[int] = []
    ev_mask: List[int] = []
    ev_arg: List[int] = []
    ev_addr: List[int] = []
    addr_rows: List[np.ndarray] = []

    def walk(stmts: Sequence[Stmt], mask: np.ndarray) -> None:
        if not mask.any():
            return
        mrow = row_of(mask)
        for s in stmts:
            if isinstance(s, Compute):
                ev_kind.append(TEV_COMPUTE)
                ev_mask.append(mrow)
                ev_arg.append(s.n)
                ev_addr.append(-1)
            elif isinstance(s, Mem):
                uid[0] += 1
                addrs = coalesce.generate_addresses(s, uid[0], n, rng)
                tid = tid_cache.get(mrow)
                if tid is None:
                    tid = tid_cache[mrow] = np.nonzero(mask)[0]
                ev_kind.append(TEV_LOAD if s.is_load else TEV_STORE)
                ev_mask.append(mrow)
                ev_arg.append(0)
                ev_addr.append(len(addr_rows))
                addr_rows.append(addrs[tid])
            elif isinstance(s, Loop):
                for _ in range(s.trips):
                    walk(s.body, mask)
                    # MIMD fragment re-formation at the loop boundary;
                    # SIMT aggregation skips RESET events.
                    ev_kind.append(TEV_RESET)
                    ev_mask.append(mrow)
                    ev_arg.append(0)
                    ev_addr.append(-1)
            elif isinstance(s, Branch):
                # The branch instruction itself.
                ev_kind.append(TEV_COMPUTE)
                ev_mask.append(mrow)
                ev_arg.append(1)
                ev_addr.append(-1)
                outcome = correlated_outcomes(rng, n, s.p_taken, s.corr)
                m_then = mask & outcome
                m_else = mask & ~outcome
                # SPLIT carries the then-mask: for threads of `mask`,
                # membership in it *is* the branch outcome (MIMD fragment
                # update); SIMT aggregation skips SPLIT events.
                ev_kind.append(TEV_SPLIT)
                ev_mask.append(mrow)
                ev_arg.append(row_of(m_then))
                ev_addr.append(-1)
                walk(s.then, m_then)
                walk(s.orelse, m_else)
            else:
                raise TypeError(f"unknown stmt {type(s)}")

    walk(workload.program, np.ones(n, dtype=bool))

    masks = (np.stack(mask_list) if mask_list
             else np.zeros((0, n), dtype=bool))
    addr_off = np.zeros(len(addr_rows) + 1, dtype=np.int64)
    if addr_rows:
        np.cumsum([len(r) for r in addr_rows], out=addr_off[1:])
    addr_vals = (np.concatenate(addr_rows) if addr_rows
                 else np.zeros(0, dtype=np.int64))
    return ThreadTrace(
        n_threads=n,
        ev_kind=np.asarray(ev_kind, dtype=np.int8),
        ev_mask=np.asarray(ev_mask, dtype=np.int32),
        ev_arg=np.asarray(ev_arg, dtype=np.int64),
        ev_addr=np.asarray(ev_addr, dtype=np.int64),
        masks=masks, addr_off=addr_off, addr_vals=addr_vals,
    )


def _assemble_stream(n_warps: int, simd: int, warp, issue, tins, kind,
                     maccs, blen, blocks, nbytes) -> WarpStream:
    """Emission-order columns -> CSR :class:`WarpStream` (block-pool
    offsets, stable per-warp grouping)."""
    blk_off = np.zeros(len(blen), dtype=np.int64)
    if len(blen):
        np.cumsum(blen[:-1], out=blk_off[1:])
    perm = np.argsort(warp, kind="stable")
    warp = warp[perm]
    op_start = np.searchsorted(warp, np.arange(n_warps + 1))
    return WarpStream(
        n_warps=n_warps, warp=warp, issue=issue[perm], tins=tins[perm],
        lanes=issue[perm] * simd, kind=kind[perm], maccs=maccs[perm],
        blk_off=blk_off[perm], blk_len=blen[perm], blocks=blocks,
        nbytes=nbytes, op_start=op_start,
    )


def aggregate_stream(trace: ThreadTrace, cfg: MachineConfig) -> WarpStream:
    """Phase 2: replay a :class:`ThreadTrace` for one expansion key.

    All-integer arithmetic and canonical sort orders, so the stream is a
    pure function of ``(trace, cfg.expansion_key())``.
    """
    n = trace.n_threads
    ws = cfg.warp_size
    if n % ws:
        raise ValueError(f"n_threads {n} not a multiple of warp size {ws}")
    n_warps = n // ws
    simd = cfg.simd_width

    g_simt = cfg.issue_cycles_per_group
    tb = cfg.transaction_bytes
    mimd = cfg.mimd
    warp_of_thread = np.arange(n) // ws

    c_warp: List[np.ndarray] = []
    c_issue: List[np.ndarray] = []
    c_tins: List[np.ndarray] = []
    c_kind: List[np.ndarray] = []
    c_maccs: List[np.ndarray] = []
    c_blen: List[np.ndarray] = []
    c_blocks: List[np.ndarray] = []
    c_nbytes: List[np.ndarray] = []

    masks = trace.masks
    tid_off, tid_cat = trace.tid_csr()

    # Per-mask-row (tid, warp ids, per-warp counts), memoized per row.
    row_stats: dict = {}

    def _row_stats(row: int):
        ent = row_stats.get(row)
        if ent is None:
            tid = tid_cat[tid_off[row]:tid_off[row + 1]]
            warp_all = warp_of_thread[tid]
            act = np.bincount(warp_all, minlength=n_warps)
            w_idx = np.nonzero(act)[0]
            ent = row_stats[row] = (tid, warp_all, w_idx, act[w_idx])
        return ent

    zeros_cache: dict = {}
    kind_cache: dict = {}

    def _zeros(m: int) -> np.ndarray:
        z = zeros_cache.get(m)
        if z is None:
            z = zeros_cache[m] = np.zeros(m, dtype=np.int64)
        return z

    def append(warps, issue, tins, kind, maccs, blen, blocks=None,
               nbytes=None):
        m = len(warps)
        c_warp.append(np.asarray(warps, dtype=np.int64))
        c_issue.append(np.asarray(issue, dtype=np.int64))
        c_tins.append(np.asarray(tins, dtype=np.int64))
        kc = kind_cache.get((kind, m))
        if kc is None:
            kc = kind_cache[(kind, m)] = np.full(m, kind, dtype=np.int8)
        c_kind.append(kc)
        c_maccs.append(np.asarray(maccs, dtype=np.int64))
        c_blen.append(np.asarray(blen, dtype=np.int64))
        if blocks is not None:
            c_blocks.append(np.asarray(blocks, dtype=np.int64))
            c_nbytes.append(np.asarray(nbytes, dtype=np.int64))

    frag_id = np.zeros(n, dtype=np.int64) if mimd else None

    ev_kind = trace.ev_kind
    ev_mask = trace.ev_mask
    ev_arg = trace.ev_arg
    ev_addr = trace.ev_addr
    addr_off = trace.addr_off
    addr_vals = trace.addr_vals

    for i in range(trace.n_events):
        k = ev_kind[i]
        row = ev_mask[i]
        if k == TEV_COMPUTE:
            count = int(ev_arg[i])
            _, _, w_idx, a = _row_stats(row)
            if mimd:
                issue = count * -(-a // simd)
            else:
                issue = np.full(len(w_idx), count * g_simt, dtype=np.int64)
            z = _zeros(len(w_idx))
            append(w_idx, issue, count * a, KIND_COMPUTE, z, z)
        elif k == TEV_LOAD or k == TEV_STORE:
            tid, warp_all, w_idx, a = _row_stats(row)
            r = ev_addr[i]
            blocks_all = addr_vals[addr_off[r]:addr_off[r + 1]] // tb
            if mimd:
                keys = (warp_all, frag_id[tid])
            else:
                keys = (warp_all,)
            uwarp, ublocks, unbytes = _grouped_transactions(
                keys, blocks_all, tb)
            starts = np.searchsorted(uwarp, w_idx, side="left")
            ends = np.searchsorted(uwarp, w_idx, side="right")
            if mimd:
                issue = -(-a // simd)
            else:
                issue = np.full(len(w_idx), g_simt, dtype=np.int64)
            append(w_idx, issue, a,
                   KIND_LOAD if k == TEV_LOAD else KIND_STORE,
                   a, ends - starts, ublocks, unbytes)
        elif k == TEV_SPLIT:
            if mimd:
                mask = masks[row]
                then_mask = masks[ev_arg[i]]
                sorted_f = np.sort(frag_id.reshape(n_warps, ws), axis=1)
                nf = 1 + (sorted_f[:, 1:] != sorted_f[:, :-1]).sum(axis=1)
                can_split = (nf < 4)[warp_of_thread]
                upd = mask & can_split
                frag_id[upd] = frag_id[upd] * 2 + then_mask[upd]
        elif k == TEV_RESET:
            if mimd:
                frag_id[masks[row]] = 0
        else:
            raise ValueError(f"unknown trace event kind {k}")

    if c_warp:
        warp = np.concatenate(c_warp)
        issue = np.concatenate(c_issue)
        tins = np.concatenate(c_tins)
        kind = np.concatenate(c_kind)
        maccs = np.concatenate(c_maccs)
        blen = np.concatenate(c_blen)
    else:
        warp = issue = tins = maccs = blen = np.zeros(0, dtype=np.int64)
        kind = np.zeros(0, dtype=np.int8)
    blocks = (np.concatenate(c_blocks) if c_blocks
              else np.zeros(0, dtype=np.int64))
    nbytes = (np.concatenate(c_nbytes) if c_nbytes
              else np.zeros(0, dtype=np.int64))
    return _assemble_stream(n_warps, simd, warp, issue, tins, kind, maccs,
                            blen, blocks, nbytes)


def expand_stream(workload: Workload, cfg: MachineConfig,
                  trace: Optional[ThreadTrace] = None) -> WarpStream:
    """Expand a workload into the struct-of-arrays op streams for `cfg`.

    Two-phase: builds (or reuses, via `trace`) the expansion-key-independent
    :class:`~repro_torch.core.warpsim.trace.ThreadTrace`, then aggregates
    it for ``cfg.expansion_key()``. Callers sweeping many expansion keys of
    one workload should build the trace once and pass it in.
    """
    if trace is None:
        trace = build_thread_trace(workload)
    return aggregate_stream(trace, cfg)


def simd_efficiency(stream: WarpStream) -> float:
    """Useful thread-instructions per issued lane-slot."""
    useful = int(stream.tins.sum())
    slots = int(stream.lanes.sum())
    return useful / max(slots, 1)
