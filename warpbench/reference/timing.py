"""The study's timing model, stated plainly, over one warp-op stream.

Each SM issues its ready warps one op at a time into a SIMD pipeline: a
compute op makes the warp ready ``pipeline_depth`` cycles after it
issues; a load waits for its slowest block (an L1 hit after one cycle, a
merge into an outstanding read on SW+, else a DRAM transaction); a store
occupies DRAM bandwidth but the warp goes on after one cycle. The DRAM is
``num_mem_ctrls`` bandwidth servers with a fixed latency; the L1 is
set-associative LRU whose lines are pending until their fill arrives.
The warp that is ready first issues next (the lower warp id on a tie).

`ftype` is the arithmetic of every time: ``float``, the IEEE double the
model states (``numpy.float32`` gives the same bits at the paper's sizes:
every time is a multiple of 1/128 cycle below 2**17). `later_first`
breaks ties for the warp with the higher id instead: the control, which
breaks the stated issue order.
"""

from __future__ import annotations

import heapq
from typing import Dict, Mapping


def dram_cycles_per_transaction(m: Mapping) -> float:
    """Core cycles one transaction occupies a controller: each of the
    ``num_sms`` SMs keeps its share of the 16-SM machine's bandwidth."""
    bw = m["dram_bw_gbps"] * (m["num_sms"] / 16.0)
    per_ctrl = bw * 1e9 / m["num_mem_ctrls"]
    return m["transaction_bytes"] / per_ctrl * m["core_clock_ghz"] * 1e9


def simulate(stream: Mapping, m: Mapping, ftype=float,
             later_first: bool = False) -> Dict:
    """The record of one cell: `stream` from :func:`expand.expand`, `m` the
    machine's fields."""
    f = ftype
    n_warps, n_sms = stream["n_warps"], m["num_sms"]
    nctrl, ways = m["num_mem_ctrls"], m["l1_ways"]
    n_sets = m["l1_size_bytes"] // (m["transaction_bytes"] * ways)
    ideal = bool(m["ideal_coalescing"])
    svc = f(dram_cycles_per_transaction(m))
    lat, depth = f(m["dram_latency_cycles"]), f(m["pipeline_depth"])
    hit = f(m["l1_hit_latency"])
    zero = f(0.0)
    start_of = stream["op_start"].tolist()
    issue = [f(x) for x in stream["issue"].tolist()]
    kind = stream["kind"].tolist()
    blk_off, blk_len = stream["blk_off"].tolist(), stream["blk_len"].tolist()
    blocks, nbytes = stream["blocks"].tolist(), stream["nbytes"].tolist()
    store_svc = [svc * f(max(nb, 32) / 64.0) for nb in nbytes]

    issue_free = [zero] * n_sms
    ctrl_free = [zero] * nctrl
    l1 = [dict() for _ in range(n_sms)]      # (sm) set -> block -> [tick, fill]
    tick = [0] * n_sms
    outstanding = [dict() for _ in range(n_sms)]
    nxt = start_of[:n_warps]
    end = start_of[1:]
    sign = -1 if later_first else 1      # heap keys are (ready, sign * w)
    heap = [(zero, sign * w) for w in range(n_warps) if nxt[w] < end[w]]
    heapq.heapify(heap)
    offchip = merged = l1_hits = 0
    while heap:
        ready, key = heapq.heappop(heap)
        w = sign * key
        sm = min(w * n_sms // n_warps, n_sms - 1)
        i = nxt[w]
        t = max(ready, issue_free[sm]) + issue[i]
        issue_free[sm] = t
        o, n = blk_off[i], blk_len[i]
        if kind[i] == 0:
            warp_ready = t + depth
        elif kind[i] == 1:
            done = t + hit
            for b in blocks[o:o + n]:
                tick[sm] += 1
                lines = l1[sm].setdefault(b % n_sets, {})
                line = lines.get(b)
                if line is not None:
                    line[0] = tick[sm]
                    if line[1] <= t:
                        l1_hits += 1
                        continue
                if ideal:
                    out = outstanding[sm].get(b)
                    if out is not None and out > t:
                        merged += 1
                        done = max(done, out)
                        continue
                c = b % nctrl
                begin = max(ctrl_free[c], t)
                ctrl_free[c] = begin + svc
                fill = begin + lat + svc
                offchip += 1
                tick[sm] += 1
                if line is not None:
                    line[0] = tick[sm]
                    line[1] = min(line[1], fill)
                else:
                    if len(lines) >= ways:
                        del lines[min(lines, key=lambda x: lines[x][0])]
                    lines[b] = [tick[sm], fill]
                if ideal:
                    outstanding[sm][b] = fill
                done = max(done, fill)
            warp_ready = done
        else:
            for j in range(o, o + n):
                c = blocks[j] % nctrl
                ctrl_free[c] = max(ctrl_free[c], t) + store_svc[j]
            offchip += n
            warp_ready = t + hit
        nxt[w] = i + 1
        if i + 1 < end[w]:
            heapq.heappush(heap, (warp_ready, key))

    cycles = max(max(issue_free), f(1.0))
    busy = f(float(stream["issue"].sum()))
    lanes = int(stream["issue"].sum()) * m["simd_width"]
    return {
        "cycles": float(cycles),
        "thread_insns": int(stream["tins"].sum()),
        "mem_insns": int(stream["maccs"].sum()),
        "offchip_requests": offchip,
        "merged_requests": merged,
        "l1_hits": l1_hits,
        "idle_cycles": float((n_sms * cycles - busy) / n_sms),
        "busy_cycles": float(busy / n_sms),
        "simd_eff": int(stream["tins"].sum()) / max(lanes, 1),
    }

