"""Expand a workload into per-warp macro-ops for one machine, in one walk.

The study's divergence and coalescing model, stated plainly: the program
is walked over the whole thread pool with the active mask of an
immediate-post-dominator reconvergence stack. A SIMT warp pays full issue
slots for each side of a branch; an MIMD warp (LW+) pays for its active
threads only, but its fragments, once split, never reconverge within a
loop iteration, and memory accesses coalesce only within a fragment. A
memory instruction becomes one transaction per distinct block each warp
(or fragment) touches.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from warpbench.reference.workloads import (
    PROGRAMS, WORD, Branch, Compute, Loop, Mem, Stmt, addresses,
    correlated_outcomes,
)

KIND_COMPUTE, KIND_LOAD, KIND_STORE = 0, 1, 2


def _transactions(keys, blocks, block_bytes):
    """Per group (keys major to minor): its major key, each distinct block
    it touches in ascending order, and the bytes touched in that block."""
    order = np.lexsort((blocks,) + tuple(reversed(keys)))
    sk = [k[order] for k in keys]
    sb = blocks[order]
    new = np.ones(len(sb), dtype=bool)
    changed = sb[1:] != sb[:-1]
    for k in sk:
        changed |= k[1:] != k[:-1]
    new[1:] = changed
    first = np.flatnonzero(new)
    counts = np.diff(np.append(first, len(sb)))
    return sk[0][first], sb[first], np.minimum(counts * WORD, block_bytes)


def expand(bench: str, n_threads: int, seed: int, warp_size: int,
           simd_width: int, mimd: bool, transaction_bytes: int
           ) -> Dict[str, np.ndarray]:
    """The warp-op stream of one workload on one expansion (warp size,
    SIMD width, MIMD, transaction bytes), grouped by warp in program order:
    ``op_start`` (CSR over warps), per op ``issue``, ``tins``, ``kind``,
    ``maccs``, ``blk_off``, ``blk_len``, and the ``blocks`` / ``nbytes``
    pools."""
    n, ws, simd, tb = n_threads, warp_size, simd_width, transaction_bytes
    if n % ws:
        raise ValueError(f"n_threads {n} not a multiple of warp size {ws}")
    n_warps = n // ws
    warp_of = np.arange(n) // ws
    groups = max(1, ws // simd)          # issue cycles a SIMT warp takes
    rng = np.random.default_rng(seed)
    uid = [0]
    frag = np.zeros(n, dtype=np.int64)
    cols: Dict[str, List[np.ndarray]] = {
        k: [] for k in ("warp", "issue", "tins", "kind", "maccs", "blen",
                        "blocks", "nbytes")}

    def active(mask):
        tid = np.flatnonzero(mask)
        w_all = warp_of[tid]
        act = np.bincount(w_all, minlength=n_warps)
        w = np.flatnonzero(act)
        return tid, w_all, w, act[w]

    def emit(w, issue, tins, kind, maccs, blen):
        cols["warp"].append(w)
        cols["issue"].append(np.broadcast_to(issue, w.shape).astype(np.int64))
        cols["tins"].append(np.asarray(tins, dtype=np.int64))
        cols["kind"].append(np.full(len(w), kind, dtype=np.int8))
        cols["maccs"].append(np.broadcast_to(maccs, w.shape).astype(np.int64))
        cols["blen"].append(np.broadcast_to(blen, w.shape).astype(np.int64))

    def compute(mask, count):
        _, _, w, a = active(mask)
        issue = count * -(-a // simd) if mimd else count * groups
        emit(w, issue, count * a, KIND_COMPUTE, 0, 0)

    def memory(mask, stmt: Mem):
        uid[0] += 1
        addr = addresses(stmt, uid[0], n, rng)
        tid, w_all, w, a = active(mask)
        keys = (w_all, frag[tid]) if mimd else (w_all,)
        uw, ub, unb = _transactions(keys, addr[tid] // tb, tb)
        blen = (np.searchsorted(uw, w, side="right")
                - np.searchsorted(uw, w, side="left"))
        issue = -(-a // simd) if mimd else groups
        emit(w, issue, a, KIND_LOAD if stmt.is_load else KIND_STORE, a, blen)
        cols["blocks"].append(ub)
        cols["nbytes"].append(unb)

    def walk(stmts: Sequence[Stmt], mask):
        if not mask.any():
            return
        for s in stmts:
            if isinstance(s, Compute):
                compute(mask, s.n)
            elif isinstance(s, Mem):
                memory(mask, s)
            elif isinstance(s, Loop):
                for _ in range(s.trips):
                    walk(s.body, mask)
                    if mimd:
                        frag[mask] = 0   # warps re-form at the loop edge
            elif isinstance(s, Branch):
                compute(mask, 1)         # the branch instruction
                taken = correlated_outcomes(rng, n, s.p_taken, s.corr)
                if mimd:
                    # At most 4 fragments a warp: a warp that has 4 splits
                    # no further.
                    f = np.sort(frag.reshape(n_warps, ws), axis=1)
                    nf = 1 + (f[:, 1:] != f[:, :-1]).sum(axis=1)
                    upd = mask & (nf < 4)[warp_of]
                    frag[upd] = frag[upd] * 2 + taken[upd]
                walk(s.then, mask & taken)
                walk(s.orelse, mask & ~taken)
            else:
                raise TypeError(f"unknown statement {s!r}")

    walk(PROGRAMS[bench], np.ones(n, dtype=bool))

    def cat(name, dtype):
        parts = cols[name]
        return (np.concatenate(parts) if parts
                else np.zeros(0, dtype=dtype)).astype(dtype, copy=False)

    warp = cat("warp", np.int64)
    blen = cat("blen", np.int64)
    blk_off = np.zeros(len(blen), dtype=np.int64)
    np.cumsum(blen[:-1], out=blk_off[1:])
    perm = np.argsort(warp, kind="stable")
    return {
        "n_warps": n_warps,
        "op_start": np.searchsorted(warp[perm], np.arange(n_warps + 1)),
        "issue": cat("issue", np.int64)[perm],
        "tins": cat("tins", np.int64)[perm],
        "kind": cat("kind", np.int8)[perm],
        "maccs": cat("maccs", np.int64)[perm],
        "blk_off": blk_off[perm],
        "blk_len": blen[perm],
        "blocks": cat("blocks", np.int64),
        "nbytes": cat("nbytes", np.int64),
    }
