"""SM / DRAM timing model: the host engines, result assembly and the
single-cell entry point.

Scheduling model (paper §2): each SM has one scheduler issuing ready warps
back-to-back into a 24-stage, SIMD-wide pipeline. A warp's next macro-op
becomes ready `pipeline_depth` cycles after its compute op is issued, or
when its slowest memory transaction completes (memory divergence: all
threads of the warp wait for the slowest — §1). Idle cycles are issue
cycles in which no warp is ready (§3). The DRAM system is a set of memory
controllers, each a bandwidth server (fixed access latency + per-64 B
transaction bus occupancy); SW+'s ideal coalescing merges read requests
with in-flight requests to the same block across the whole SM.

Six engines run the model, all bit for bit the same (IEEE-754 double,
the same operations in the same order):

* ``engine="cuda"`` — the family kernels of
  :mod:`repro_torch.core.warpsim._cuda` on a CUDA `device` (one launch
  simulates a whole trace family when a sweep drives it; one cell here is
  a one-unit family).
* ``engine="torch"`` — their plain PyTorch versions, on the CPU.
* ``engine="event"`` — the discrete-event loop over ``List[List[WarpOp]]``
  streams (:func:`_simulate_event`, with :class:`DRAM` and
  :class:`~repro_torch.core.warpsim.coalesce.L1Cache`): the readable
  statement of the model, the specification the others are held to.
* ``engine="fast"`` — the flat-CSR loop over a :class:`WarpStream`'s
  columns (:func:`_simulate_fast`): a heap over warps, stores drained in
  one numpy pass per wide store (:func:`_drain_stores_vectorized`, the
  scalar loop's exact addition sequence), and a heap peek that keeps
  issuing a warp the loop would pop right back.
* ``engine="fast_nested"`` — the earlier generation of ``fast``, over
  per-warp nested lists (:func:`_normalize`): the engine of
  ``sweep_bench``'s ``cold_pr1`` baseline.
* ``engine="native"`` — ``fast``'s loop in C
  (``csrc/warpsim_loop.c`` through :mod:`~repro_torch.core.warpsim._native`,
  built at first use; a failed build raises).

The four host engines (``event``, ``fast``, ``fast_nested``, ``native``)
run on the host CPU whatever the `device`; they run when a caller names
them. ``"auto"`` resolves from `device` (``cuda`` on a card, ``torch`` on
the CPU). ``"pallas"`` is the reference's device engine; the port's is
``"cuda"``, and asking for ``"pallas"`` raises.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import List, Union

import numpy as np

from repro_torch.core.warpsim import _native
from repro_torch.core.warpsim.coalesce import L1Cache
from repro_torch.core.warpsim.config import MachineConfig
from repro_torch.core.warpsim.divergence import (
    KIND_COMPUTE, KIND_LOAD, KIND_STORE, WarpOp, WarpStream, simd_efficiency,
)

#: The engines that run on the host CPU, on any device.
HOST_ENGINES = ("native", "fast", "fast_nested", "event")


@dataclasses.dataclass
class SimResult:
    name: str
    machine: str
    cycles: float
    thread_insns: int
    mem_insns: int                # thread-level memory instructions
    offchip_requests: int         # DRAM transactions after all merging
    merged_requests: int          # requests absorbed by ideal coalescing
    l1_hits: int
    idle_cycles: float
    busy_cycles: float
    simd_eff: float

    @property
    def ipc(self) -> float:
        return self.thread_insns / max(self.cycles, 1.0)

    @property
    def coalescing_rate(self) -> float:
        """Paper eq. (1): off-chip requests per memory instruction (lower
        is better coalescing)."""
        return self.offchip_requests / max(self.mem_insns, 1)

    @property
    def idle_share(self) -> float:
        return self.idle_cycles / max(self.cycles, 1.0)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(ipc=self.ipc, coalescing_rate=self.coalescing_rate,
                 idle_share=self.idle_share)
        return d


class DRAM:
    """num_ctrls bandwidth servers with fixed access latency."""

    def __init__(self, cfg: MachineConfig):
        self.ctrl_free = [0.0] * cfg.num_mem_ctrls
        self.latency = float(cfg.dram_latency_cycles)
        self.svc = cfg.dram_cycles_per_transaction
        self.n = cfg.num_mem_ctrls

    def request(self, block: int, now: float, nbytes: int = 64) -> float:
        c = int(block) % self.n
        # Minimum 32 B burst: a scattered 4 B store still occupies half a
        # transaction slot (GDDR burst granularity).
        svc = self.svc * (max(nbytes, 32) / 64.0)
        start = max(self.ctrl_free[c], now)
        self.ctrl_free[c] = start + svc
        return start + self.latency + svc


def stream_totals(st: WarpStream) -> tuple:
    """Order-independent totals ``(thread_insns, mem_insns, total_busy,
    simd_eff)`` of a stream — the host-side half of a result."""
    return (int(st.tins.sum()), int(st.maccs.sum()),
            float(st.issue.sum()), simd_efficiency(st))


def loop_result(name: str, cfg: MachineConfig, loop: tuple,
                totals: tuple) -> SimResult:
    """Assemble a SimResult from a scheduling loop's
    ``(raw_cycles, offchip, merged, l1_hits)`` and :func:`stream_totals`."""
    raw_cycles, offchip, merged, l1_hits = loop
    thread_insns, mem_insns, total_busy, eff = totals
    n_sms = cfg.num_sms
    cycles = max(raw_cycles, 1.0)
    # Idle share: scheduler slots with nothing to issue, averaged over SMs.
    idle = n_sms * cycles - total_busy
    return SimResult(
        name=name,
        machine=cfg.name,
        cycles=cycles,
        thread_insns=thread_insns,
        mem_insns=mem_insns,
        offchip_requests=offchip,
        merged_requests=merged,
        l1_hits=l1_hits,
        idle_cycles=idle / n_sms,
        busy_cycles=total_busy / n_sms,
        simd_eff=eff,
    )


Ops = Union[WarpStream, List[List[WarpOp]]]


def simulate(name: str, warp_ops: Ops, cfg: MachineConfig,
             engine: str = "auto", device="cuda") -> SimResult:
    """Run the timing model over one workload's expanded op streams.

    `warp_ops` is a :class:`WarpStream` (what ``expand_stream`` emits) or
    the per-warp ``List[List[WarpOp]]`` (what ``expand_workload`` emits).
    `engine` is one of :data:`HOST_ENGINES` (on the host CPU, any
    `device`), ``"cuda"`` (the family kernels on a CUDA `device`),
    ``"torch"`` (their plain versions on the CPU) or ``"auto"`` (resolved
    from `device`). All return the same result, bit for bit.
    """
    if engine == "native":
        return _simulate_native(name, warp_ops, cfg)
    if engine == "fast":
        return _simulate_fast(name, warp_ops, cfg)
    if engine == "fast_nested":
        return _simulate_fast_nested(name, warp_ops, cfg)
    if engine == "event":
        if isinstance(warp_ops, WarpStream):
            warp_ops = warp_ops.to_warp_ops()
        return _simulate_event(name, warp_ops, cfg)
    # The family engines: imported here, so that a process that runs only
    # the host engines (a sweep's pool workers) never imports torch.
    from repro_torch.core.warpsim import _cuda
    engine = _cuda.resolve_engine(engine, device)
    if isinstance(warp_ops, WarpStream):
        loop = _cuda.run_family([(warp_ops, cfg)], device, engine)[0]
        return loop_result(name, cfg, loop, stream_totals(warp_ops))
    (n_warps, op_start, issue_l, kind_l, off_l, len_l, _, _,
     blocks_np, nbytes_np, thread_insns, mem_insns, total_busy, eff
     ) = _flat_arrays(warp_ops)
    loop = _cuda.run_scheduling_loop(
        n_warps, np.asarray(op_start, dtype=np.int64),
        np.asarray(issue_l, dtype=np.int64),
        np.asarray(kind_l, dtype=np.int8),
        np.asarray(off_l, dtype=np.int64),
        np.asarray(len_l, dtype=np.int64), blocks_np, nbytes_np, cfg,
        device, engine)
    return loop_result(name, cfg, loop,
                       (thread_insns, mem_insns, total_busy, eff))


# ---------------------------------------------------------------------------
# Event engine: the specification
# ---------------------------------------------------------------------------


def _simulate_event(
    name: str,
    warp_ops: List[List[WarpOp]],
    cfg: MachineConfig,
) -> SimResult:
    n_warps = len(warp_ops)
    n_sms = cfg.num_sms
    dram = DRAM(cfg)
    l1 = [L1Cache(cfg.l1_size_bytes, cfg.l1_ways, cfg.transaction_bytes)
          for _ in range(n_sms)]
    # SW+ ideal coalescing: unbounded per-SM outstanding-read table
    # ("keeps track of outstanding memory requests of all threads", §4.1).
    outstanding: List[dict] = [dict() for _ in range(n_sms)]

    # Per-SM issue engine occupancy.
    issue_free = [0.0] * n_sms
    busy = [0.0] * n_sms
    # Contiguous thread blocks stay on one SM (CTA assignment): warp w runs
    # on SM w*n_sms//n_warps, so neighbor warps share an L1 like neighbor
    # warps of a CTA do.
    sm_of = [min(w * n_sms // max(n_warps, 1), n_sms - 1)
             for w in range(n_warps)]
    heap = [(0.0, w) for w in range(n_warps) if warp_ops[w]]
    heapq.heapify(heap)
    next_op = [0] * n_warps

    thread_insns = 0
    mem_insns = 0
    offchip = 0
    merged = 0
    l1_hits = 0

    while heap:
        ready_t, w = heapq.heappop(heap)
        sm = sm_of[w]
        op = warp_ops[w][next_op[w]]
        next_op[w] += 1

        t_start = max(ready_t, issue_free[sm])
        issue_free[sm] = t_start + op.issue_cycles
        busy[sm] += op.issue_cycles
        thread_insns += op.thread_insns

        if op.is_mem:
            mem_insns += op.mem_thread_accesses
            t_acc = t_start + op.issue_cycles
            done = t_acc + cfg.l1_hit_latency
            if not op.is_load:
                # Stores are fire-and-forget: they occupy DRAM bandwidth
                # (partial-width transactions write only touched bytes) but
                # the warp does not wait, and the L1 is write-evict (no
                # allocation) per CC-2.0.
                for block, nb in zip(op.mem_blocks, op.mem_block_bytes):
                    dram.request(int(block), t_acc, int(nb))
                    offchip += 1
                warp_ready = done
            else:
                for block in op.mem_blocks:
                    block = int(block)
                    fill = l1[sm].lookup(block)
                    if fill is not None and fill <= t_acc:
                        l1_hits += 1                # filled line: plain hit
                        continue
                    if cfg.ideal_coalescing:
                        out = outstanding[sm].get(block)
                        if out is not None and out > t_acc:
                            merged += 1             # SW+: merge, no new request
                            done = max(done, out)
                            continue
                    elif fill is not None:
                        # Line is pending and the baseline has no
                        # cross-warp merging -> redundant request
                        # (small-warp coalescing loss, paper §3).
                        pass
                    completion = dram.request(block, t_acc)
                    offchip += 1
                    l1[sm].fill(block, completion)
                    if cfg.ideal_coalescing:
                        outstanding[sm][block] = completion
                        if len(outstanding[sm]) > 4096:
                            outstanding[sm] = {
                                b: t for b, t in outstanding[sm].items()
                                if t > t_acc}
                    done = max(done, completion)
                warp_ready = done
        else:
            warp_ready = t_start + op.issue_cycles + cfg.pipeline_depth

        if next_op[w] < len(warp_ops[w]):
            heapq.heappush(heap, (warp_ready, w))

    cycles = max(max(issue_free), 1.0)
    total_busy = sum(busy)
    # Idle share: fraction of scheduler slots with nothing to issue,
    # averaged over SMs (paper Fig. 3).
    idle = n_sms * cycles - total_busy

    return SimResult(
        name=name,
        machine=cfg.name,
        cycles=cycles,
        thread_insns=thread_insns,
        mem_insns=mem_insns,
        offchip_requests=offchip,
        merged_requests=merged,
        l1_hits=l1_hits,
        idle_cycles=idle / n_sms,
        busy_cycles=total_busy / n_sms,
        simd_eff=simd_efficiency(warp_ops),
    )


# ---------------------------------------------------------------------------
# Flat-CSR fast engine
# ---------------------------------------------------------------------------


def _flat_arrays(warp_ops: Ops):
    """Flat CSR op columns + order-independent totals for the fast engines.

    Returns ``(n_warps, op_start, issue, kind, blk_off, blk_len, blocks,
    nbytes, blocks_np, nbytes_np, thread_insns, mem_insns, total_busy,
    eff)`` where the CSR columns are flat Python lists indexed by absolute
    op id (no nested per-warp/per-op lists) and ``*_np`` are the numpy
    block pools for the vectorized store drain.
    """
    if isinstance(warp_ops, WarpStream):
        st = warp_ops
        op_start, issue, kind, blk_off, blk_len, blocks, nbytes = st.flat_csr()
        return (st.n_warps, op_start, issue, kind, blk_off, blk_len,
                blocks, nbytes, st.blocks, st.nbytes,
                int(st.tins.sum()), int(st.maccs.sum()),
                float(st.issue.sum()), simd_efficiency(st))

    op_start = [0]
    issue: List[int] = []
    kind: List[int] = []
    blk_off: List[int] = []
    blk_len: List[int] = []
    blocks: List[int] = []
    nbytes: List[int] = []
    thread_insns = mem_insns = 0
    total_busy = 0
    for warp in warp_ops:
        for op in warp:
            issue.append(op.issue_cycles)
            total_busy += op.issue_cycles
            thread_insns += op.thread_insns
            blk_off.append(len(blocks))
            if op.is_mem:
                kind.append(KIND_LOAD if op.is_load else KIND_STORE)
                blk_len.append(len(op.mem_blocks))
                blocks.extend(int(b) for b in op.mem_blocks)
                nbytes.extend(int(b) for b in op.mem_block_bytes)
                mem_insns += op.mem_thread_accesses
            else:
                kind.append(KIND_COMPUTE)
                blk_len.append(0)
        op_start.append(len(issue))
    blocks_np = np.asarray(blocks, dtype=np.int64)
    nbytes_np = np.asarray(nbytes, dtype=np.int64)
    return (len(warp_ops), op_start, issue, kind, blk_off, blk_len,
            blocks, nbytes, blocks_np, nbytes_np,
            thread_insns, mem_insns, float(total_busy),
            simd_efficiency(warp_ops))


# Store ops with at least this many transactions take the numpy drain; the
# scalar loop wins below it (constant numpy dispatch overhead). Both paths
# perform the identical IEEE-754 addition sequence.
_STORE_VEC_MIN = 32


def _drain_stores_vectorized(blocks_np, nbytes_np, o, l, ctrl_free, t_acc,
                             svc_unit, nctrl) -> None:
    """Batched fire-and-forget store drain over one store op's block slice.

    Per-controller cumulative occupancy: blocks are grouped by memory
    controller with a stable sort (preserving each controller's sub-order
    within the slice) and each controller's busy time advances by a left
    fold via ``np.add.accumulate`` — the exact addition sequence of the
    reference per-block loop, so results stay bit-identical.
    """
    nb = nbytes_np[o:o + l]
    svc = svc_unit * (np.maximum(nb, 32) / 64.0)
    c = blocks_np[o:o + l] % nctrl
    order = np.argsort(c, kind="stable")
    cs = c[order]
    ss = svc[order]
    cut = np.flatnonzero(cs[1:] != cs[:-1]) + 1
    starts = [0] + cut.tolist()
    ends = cut.tolist() + [l]
    acc = np.empty(l + 1)
    for s0, s1 in zip(starts, ends):
        ctrl = int(cs[s0])
        cf = ctrl_free[ctrl]
        seg = acc[:s1 - s0 + 1]
        seg[0] = cf if cf > t_acc else t_acc
        seg[1:] = ss[s0:s1]
        np.add.accumulate(seg, out=seg)
        ctrl_free[ctrl] = float(seg[s1 - s0])


def _simulate_fast(name: str, warp_ops: Ops, cfg: MachineConfig) -> SimResult:
    (n_warps, op_start, issue_l, kind_l, off_l, len_l, blocks_l, nbytes_l,
     blocks_np, nbytes_np, thread_insns, mem_insns, total_busy, eff
     ) = _flat_arrays(warp_ops)
    n_sms = cfg.num_sms

    # DRAM (inlined bandwidth servers).
    nctrl = cfg.num_mem_ctrls
    ctrl_free = [0.0] * nctrl
    dram_lat = float(cfg.dram_latency_cycles)
    svc_unit = cfg.dram_cycles_per_transaction

    # L1 (inlined set-associative LRU with pending-fill lines, identical
    # decision sequence to coalesce.L1Cache) + SW+ outstanding tables.
    n_sets = cfg.l1_size_bytes // (cfg.transaction_bytes * cfg.l1_ways)
    ways = cfg.l1_ways
    l1_sets: List[dict] = [dict() for _ in range(n_sms)]
    l1_tick = [0] * n_sms
    outstanding: List[dict] = [dict() for _ in range(n_sms)]
    ideal = cfg.ideal_coalescing
    hit_lat = cfg.l1_hit_latency
    depth = cfg.pipeline_depth

    issue_free = [0.0] * n_sms
    sm_of = [min(w * n_sms // max(n_warps, 1), n_sms - 1)
             for w in range(n_warps)]
    # next_idx / op_end are absolute CSR op indices (sliced copies: the
    # cached flat columns are shared across simulations of this stream).
    next_idx = list(op_start[:n_warps])
    op_end = list(op_start[1:])
    heap = [(0.0, w) for w in range(n_warps) if next_idx[w] < op_end[w]]
    heapq.heapify(heap)

    offchip = 0
    merged = 0
    l1_hits = 0

    heappop = heapq.heappop
    heappush = heapq.heappush

    while heap:
        ready_t, w = heappop(heap)
        sm = sm_of[w]
        i = next_idx[w]
        end = op_end[w]
        while True:
            free = issue_free[sm]
            t_start = ready_t if ready_t > free else free
            t_acc = t_start + issue_l[i]
            issue_free[sm] = t_acc

            k = kind_l[i]
            if k == 0:                               # compute phase
                warp_ready = t_acc + depth
            elif k == 1:                             # load
                done = t_acc + hit_lat
                sets = l1_sets[sm]
                tick = l1_tick[sm]
                outst = outstanding[sm]
                o = off_l[i]
                for block in blocks_l[o:o + len_l[i]]:
                    # L1 lookup (pending lines visible with their fill time).
                    tick += 1
                    si = block % n_sets
                    s = sets.get(si)
                    if s is None:
                        s = sets[si] = {}
                    ent = s.get(block)
                    if ent is not None:
                        ent[0] = tick
                        fill = ent[1]
                        if fill <= t_acc:
                            l1_hits += 1
                            continue
                    if ideal:
                        out = outst.get(block)
                        if out is not None and out > t_acc:
                            merged += 1
                            if out > done:
                                done = out
                            continue
                    # DRAM request (full 64 B read transaction).
                    c = block % nctrl
                    cf = ctrl_free[c]
                    start = cf if cf > t_acc else t_acc
                    ctrl_free[c] = start + svc_unit
                    completion = start + dram_lat + svc_unit
                    offchip += 1
                    # L1 fill / pending-line allocation.
                    tick += 1
                    if ent is not None:
                        ent[0] = tick
                        if completion < ent[1]:
                            ent[1] = completion
                    else:
                        if len(s) >= ways:
                            victim = min(s, key=lambda b: s[b][0])  # LRU
                            del s[victim]
                        s[block] = [tick, completion]
                    if ideal:
                        outst[block] = completion
                        if len(outst) > 4096:
                            outst = {b: t for b, t in outst.items()
                                     if t > t_acc}
                            outstanding[sm] = outst
                    if completion > done:
                        done = completion
                l1_tick[sm] = tick
                warp_ready = done
            else:                                    # store: fire-and-forget
                o = off_l[i]
                l = len_l[i]
                if l >= _STORE_VEC_MIN:
                    _drain_stores_vectorized(blocks_np, nbytes_np, o, l,
                                             ctrl_free, t_acc, svc_unit,
                                             nctrl)
                else:
                    for bi in range(o, o + l):
                        nb = nbytes_l[bi]
                        c = blocks_l[bi] % nctrl
                        svc = svc_unit * ((nb if nb > 32 else 32) / 64.0)
                        cf = ctrl_free[c]
                        start = cf if cf > t_acc else t_acc
                        ctrl_free[c] = start + svc
                offchip += l
                warp_ready = t_acc + hit_lat

            i += 1
            if i == end:
                break
            # Peek: if this warp precedes the heap top in (time, warp id)
            # order, the reference loop would pop it right back — keep
            # issuing it without the push/pop round trip.
            if heap:
                h0 = heap[0]
                if warp_ready > h0[0] or (warp_ready == h0[0] and w > h0[1]):
                    next_idx[w] = i
                    heappush(heap, (warp_ready, w))
                    break
            ready_t = warp_ready

    cycles = max(max(issue_free), 1.0)
    # Idle share: fraction of scheduler slots with nothing to issue,
    # averaged over SMs (paper Fig. 3).
    idle = n_sms * cycles - total_busy

    return SimResult(
        name=name,
        machine=cfg.name,
        cycles=cycles,
        thread_insns=thread_insns,
        mem_insns=mem_insns,
        offchip_requests=offchip,
        merged_requests=merged,
        l1_hits=l1_hits,
        idle_cycles=idle / n_sms,
        busy_cycles=total_busy / n_sms,
        simd_eff=eff,
    )


# ---------------------------------------------------------------------------
# Native engine: fast's loop in C
# ---------------------------------------------------------------------------


def _simulate_native(name: str, warp_ops: Ops, cfg: MachineConfig
                     ) -> SimResult:
    """Flat-CSR loop in compiled C (``csrc/warpsim_loop.c``). Where the
    loop declines a machine (:func:`_native.run_scheduling_loop` returns
    None: its outstanding table is fixed-size), ``fast`` runs it, as in
    the reference; the numbers are the same."""
    if isinstance(warp_ops, WarpStream):
        st = warp_ops
        loop = _native.run_scheduling_loop(
            st.n_warps, st.op_start, st.issue, st.kind, st.blk_off,
            st.blk_len, st.blocks, st.nbytes, cfg)
        if loop is None:
            return _simulate_fast(name, warp_ops, cfg)
        totals = stream_totals(st)
    else:
        (n_warps, op_start, issue_l, kind_l, off_l, len_l, _, _,
         blocks_np, nbytes_np, thread_insns, mem_insns, total_busy, eff
         ) = _flat_arrays(warp_ops)
        loop = _native.run_scheduling_loop(
            n_warps, np.asarray(op_start, dtype=np.int64),
            np.asarray(issue_l, dtype=np.int64),
            np.asarray(kind_l, dtype=np.int8),
            np.asarray(off_l, dtype=np.int64),
            np.asarray(len_l, dtype=np.int64), blocks_np, nbytes_np, cfg)
        if loop is None:
            return _simulate_fast(name, warp_ops, cfg)
        totals = (thread_insns, mem_insns, total_busy, eff)
    return loop_result(name, cfg, loop, totals)


# ---------------------------------------------------------------------------
# Previous-generation fast engine (nested per-warp lists): the engine of
# the sweep bench's cold_pr1 baseline, and an independent implementation
# the tests hold the others to.
# ---------------------------------------------------------------------------


def _normalize(warp_ops: Ops):
    """Per-warp nested op phases + order-independent totals (legacy).

    Returns ``(issues, kinds, blockss, nbytess, thread_insns, mem_insns,
    total_busy, simd_eff)`` where ``issues[w][i]`` etc. are Python scalars.
    The earlier normalization that materializes one nested list per warp
    and per op — the allocation cost the flat-CSR engine removes.
    """
    if isinstance(warp_ops, WarpStream):
        st = warp_ops
        issue_l = st.issue.tolist()
        kind_l = st.kind.tolist()
        off_l = st.blk_off.tolist()
        len_l = st.blk_len.tolist()
        blocks_pool = st.blocks.tolist()
        nbytes_pool = st.nbytes.tolist()
        starts = st.op_start.tolist()
        issues, kinds, blockss, nbytess = [], [], [], []
        for w in range(st.n_warps):
            lo, hi = starts[w], starts[w + 1]
            issues.append(issue_l[lo:hi])
            kinds.append(kind_l[lo:hi])
            blockss.append([blocks_pool[off_l[i]:off_l[i] + len_l[i]]
                            for i in range(lo, hi)])
            nbytess.append([nbytes_pool[off_l[i]:off_l[i] + len_l[i]]
                            for i in range(lo, hi)])
        thread_insns = int(st.tins.sum())
        mem_insns = int(st.maccs.sum())
        total_busy = float(st.issue.sum())
        eff = simd_efficiency(st)
        return (issues, kinds, blockss, nbytess,
                thread_insns, mem_insns, total_busy, eff)

    issues, kinds, blockss, nbytess = [], [], [], []
    thread_insns = mem_insns = 0
    total_busy = 0
    for warp in warp_ops:
        wi, wk, wb, wn = [], [], [], []
        for op in warp:
            wi.append(op.issue_cycles)
            total_busy += op.issue_cycles
            thread_insns += op.thread_insns
            if op.is_mem:
                wk.append(KIND_LOAD if op.is_load else KIND_STORE)
                wb.append([int(b) for b in op.mem_blocks])
                wn.append([int(b) for b in op.mem_block_bytes])
                mem_insns += op.mem_thread_accesses
            else:
                wk.append(KIND_COMPUTE)
                wb.append(None)
                wn.append(None)
        issues.append(wi)
        kinds.append(wk)
        blockss.append(wb)
        nbytess.append(wn)
    return (issues, kinds, blockss, nbytess,
            thread_insns, mem_insns, float(total_busy),
            simd_efficiency(warp_ops))


def _simulate_fast_nested(name: str, warp_ops: Ops, cfg: MachineConfig
                          ) -> SimResult:
    (issues, kinds, blockss, nbytess,
     thread_insns, mem_insns, total_busy, eff) = _normalize(warp_ops)
    n_warps = len(issues)
    n_sms = cfg.num_sms

    # DRAM (inlined bandwidth servers).
    nctrl = cfg.num_mem_ctrls
    ctrl_free = [0.0] * nctrl
    dram_lat = float(cfg.dram_latency_cycles)
    svc_unit = cfg.dram_cycles_per_transaction

    # L1 (inlined set-associative LRU with pending-fill lines, identical
    # decision sequence to coalesce.L1Cache) + SW+ outstanding tables.
    n_sets = cfg.l1_size_bytes // (cfg.transaction_bytes * cfg.l1_ways)
    ways = cfg.l1_ways
    l1_sets: List[dict] = [dict() for _ in range(n_sms)]
    l1_tick = [0] * n_sms
    outstanding: List[dict] = [dict() for _ in range(n_sms)]
    ideal = cfg.ideal_coalescing
    hit_lat = cfg.l1_hit_latency
    depth = cfg.pipeline_depth

    issue_free = [0.0] * n_sms
    sm_of = [min(w * n_sms // max(n_warps, 1), n_sms - 1)
             for w in range(n_warps)]
    heap = [(0.0, w) for w in range(n_warps) if issues[w]]
    heapq.heapify(heap)
    next_op = [0] * n_warps
    n_ops_of = [len(x) for x in issues]

    offchip = 0
    merged = 0
    l1_hits = 0

    heappop = heapq.heappop
    heappush = heapq.heappush

    while heap:
        ready_t, w = heappop(heap)
        sm = sm_of[w]
        i = next_op[w]
        next_op[w] = i + 1

        free = issue_free[sm]
        t_start = ready_t if ready_t > free else free
        t_acc = t_start + issues[w][i]
        issue_free[sm] = t_acc

        k = kinds[w][i]
        if k == 0:                                   # compute phase
            warp_ready = t_acc + depth
        elif k == 2:                                 # store: fire-and-forget
            for block, nb in zip(blockss[w][i], nbytess[w][i]):
                c = block % nctrl
                svc = svc_unit * ((nb if nb > 32 else 32) / 64.0)
                cf = ctrl_free[c]
                start = cf if cf > t_acc else t_acc
                ctrl_free[c] = start + svc
                offchip += 1
            warp_ready = t_acc + hit_lat
        else:                                        # load
            done = t_acc + hit_lat
            sets = l1_sets[sm]
            tick = l1_tick[sm]
            outst = outstanding[sm]
            for block in blockss[w][i]:
                # L1 lookup (pending lines visible with their fill time).
                tick += 1
                si = block % n_sets
                s = sets.get(si)
                if s is None:
                    s = sets[si] = {}
                ent = s.get(block)
                if ent is not None:
                    ent[0] = tick
                    fill = ent[1]
                    if fill <= t_acc:
                        l1_hits += 1
                        continue
                else:
                    fill = None
                if ideal:
                    out = outst.get(block)
                    if out is not None and out > t_acc:
                        merged += 1
                        if out > done:
                            done = out
                        continue
                # DRAM request (full 64 B read transaction).
                c = block % nctrl
                cf = ctrl_free[c]
                start = cf if cf > t_acc else t_acc
                ctrl_free[c] = start + svc_unit
                completion = start + dram_lat + svc_unit
                offchip += 1
                # L1 fill / pending-line allocation.
                tick += 1
                if ent is not None:
                    ent[0] = tick
                    if completion < ent[1]:
                        ent[1] = completion
                else:
                    if len(s) >= ways:
                        victim = min(s, key=lambda b: s[b][0])  # LRU
                        del s[victim]
                    s[block] = [tick, completion]
                if ideal:
                    outst[block] = completion
                    if len(outst) > 4096:
                        outst = {b: t for b, t in outst.items() if t > t_acc}
                        outstanding[sm] = outst
                if completion > done:
                    done = completion
            l1_tick[sm] = tick
            warp_ready = done

        if next_op[w] < n_ops_of[w]:
            heappush(heap, (warp_ready, w))

    cycles = max(max(issue_free), 1.0)
    # Idle share: fraction of scheduler slots with nothing to issue,
    # averaged over SMs (paper Fig. 3).
    idle = n_sms * cycles - total_busy

    return SimResult(
        name=name,
        machine=cfg.name,
        cycles=cycles,
        thread_insns=thread_insns,
        mem_insns=mem_insns,
        offchip_requests=offchip,
        merged_requests=merged,
        l1_hits=l1_hits,
        idle_cycles=idle / n_sms,
        busy_cycles=total_busy / n_sms,
        simd_eff=eff,
    )
