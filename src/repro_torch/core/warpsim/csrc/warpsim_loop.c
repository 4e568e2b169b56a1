/* Host C core of the warp-size study's timing model: the scheduling loop.
 *
 * warpsim_run runs the scheduling loop of timing._simulate_fast over one
 * WarpStream's flat CSR columns on one machine, operand for operand: the
 * same IEEE-754 double operations in the same order (built with
 * -ffp-contract=off, so no FMA contraction), heap ties broken on the warp
 * id as Python's heapq breaks them on (float, int) tuples, LRU eviction
 * by unique touch tick, and the outstanding table pruned at the same
 * threshold. So it is bit for bit the event, fast and fast_nested engines
 * and the family kernel (K2). Built with
 *     cc -O2 -fPIC -shared -ffp-contract=off -fno-fast-math
 * by _native.py and bound through ctypes: the "native" engine, on the
 * host CPU.  */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* ----------------------------------------------------------------- heap
 * Binary min-heap of (time, warp) with lexicographic order — identical
 * tie-breaking to Python's heapq over (float, int) tuples.  */
typedef struct { double t; int64_t w; } HeapEnt;

static inline int ent_less(HeapEnt a, HeapEnt b) {
    return a.t < b.t || (a.t == b.t && a.w < b.w);
}

static void heap_push(HeapEnt *h, int64_t *n, HeapEnt e) {
    int64_t i = (*n)++;
    h[i] = e;
    while (i > 0) {
        int64_t p = (i - 1) >> 1;
        if (!ent_less(h[i], h[p])) break;
        HeapEnt tmp = h[p]; h[p] = h[i]; h[i] = tmp;
        i = p;
    }
}

static HeapEnt heap_pop(HeapEnt *h, int64_t *n) {
    HeapEnt top = h[0];
    h[0] = h[--(*n)];
    int64_t i = 0;
    for (;;) {
        int64_t l = 2 * i + 1, r = l + 1, s = i;
        if (l < *n && ent_less(h[l], h[s])) s = l;
        if (r < *n && ent_less(h[r], h[s])) s = r;
        if (s == i) break;
        HeapEnt tmp = h[s]; h[s] = h[i]; h[i] = tmp;
        i = s;
    }
    return top;
}

/* ------------------------------------------------- outstanding table
 * Open-addressing hash map block -> completion time (SW+ ideal
 * coalescing).  Pruned to entries still in flight once it grows past
 * 4096 entries, matching the dict rebuild in the Python engines.  */
#define OUT_CAP 16384            /* max live entries 4097 -> load < 0.26 */
#define OUT_MASK (OUT_CAP - 1)

typedef struct {
    int64_t key[OUT_CAP];        /* -1 = empty (block ids are >= 0) */
    double  val[OUT_CAP];
    int64_t count;
} OutTable;

static inline uint64_t out_slot(int64_t block) {
    return ((uint64_t)block * 0x9E3779B97F4A7C15ull) & OUT_MASK;
}

static double *out_find(OutTable *o, int64_t block) {
    uint64_t i = out_slot(block);
    while (o->key[i] != -1) {
        if (o->key[i] == block) return &o->val[i];
        i = (i + 1) & OUT_MASK;
    }
    return 0;
}

static void out_put(OutTable *o, int64_t block, double val) {
    uint64_t i = out_slot(block);
    while (o->key[i] != -1) {
        if (o->key[i] == block) { o->val[i] = val; return; }
        i = (i + 1) & OUT_MASK;
    }
    o->key[i] = block;
    o->val[i] = val;
    o->count++;
}

static void out_prune(OutTable *o, double t_acc, int64_t *kbuf, double *vbuf) {
    int64_t kept = 0;
    for (int64_t i = 0; i < OUT_CAP; i++) {
        if (o->key[i] != -1 && o->val[i] > t_acc) {
            kbuf[kept] = o->key[i];
            vbuf[kept] = o->val[i];
            kept++;
        }
    }
    memset(o->key, 0xff, sizeof(o->key));
    o->count = 0;
    for (int64_t i = 0; i < kept; i++) out_put(o, kbuf[i], vbuf[i]);
}

/* ----------------------------------------------------------- simulate
 * The scheduling loop of timing._simulate_fast, operand for operand.
 * L1 lines live in flat [sm][set][way] arrays; LRU victim = min touch
 * tick (ticks are unique, so the victim is deterministic).
 * Returns 0 on success, 1 on allocation failure.  */
int warpsim_run(
    int64_t n_warps,
    const int64_t *op_start,     /* [n_warps+1] CSR row offsets          */
    const int64_t *issue,        /* [n_ops] front-end occupancy          */
    const int8_t  *kind,         /* [n_ops] 0 compute / 1 load / 2 store */
    const int64_t *blk_off,      /* [n_ops] offset into block pools      */
    const int64_t *blk_len,      /* [n_ops] transactions of this op      */
    const int64_t *blocks,       /* block pool                           */
    const int64_t *nbytes,       /* touched bytes per transaction        */
    int64_t n_sms, int64_t nctrl, int64_t n_sets, int64_t ways,
    int64_t ideal,
    double svc_unit, double dram_lat, double hit_lat, double depth,
    double *out)                 /* [4] cycles, offchip, merged, l1_hits */
{
    int64_t lines = n_sms * n_sets * ways;
    size_t ws_bytes =
        (size_t)n_warps * sizeof(HeapEnt) +        /* heap               */
        (size_t)n_warps * 2 * sizeof(int64_t) +    /* next_idx, op_end   */
        (size_t)n_sms * sizeof(double) +           /* issue_free         */
        (size_t)nctrl * sizeof(double) +           /* ctrl_free          */
        (size_t)lines * 2 * sizeof(int64_t) +      /* l1 block, tick     */
        (size_t)lines * sizeof(double) +           /* l1 fill            */
        (size_t)(n_sms * n_sets) * sizeof(int64_t) + /* l1 per-set count */
        (size_t)n_sms * sizeof(int64_t);           /* l1 tick counter    */
    char *ws = malloc(ws_bytes);
    if (!ws) return 1;
    memset(ws, 0, ws_bytes);
    char *p = ws;
    HeapEnt *heap   = (HeapEnt *)p;  p += n_warps * sizeof(HeapEnt);
    int64_t *next_i = (int64_t *)p;  p += n_warps * sizeof(int64_t);
    int64_t *op_end = (int64_t *)p;  p += n_warps * sizeof(int64_t);
    double *issue_free = (double *)p; p += n_sms * sizeof(double);
    double *ctrl_free  = (double *)p; p += nctrl * sizeof(double);
    int64_t *l1_block = (int64_t *)p; p += lines * sizeof(int64_t);
    int64_t *l1_tick  = (int64_t *)p; p += lines * sizeof(int64_t);
    double  *l1_fill  = (double *)p;  p += lines * sizeof(double);
    int64_t *l1_count = (int64_t *)p; p += n_sms * n_sets * sizeof(int64_t);
    int64_t *tick_of  = (int64_t *)p;

    OutTable *outst = 0;
    int64_t *kbuf = 0;
    double *vbuf = 0;
    if (ideal) {
        outst = malloc((size_t)n_sms * sizeof(OutTable));
        kbuf = malloc(OUT_CAP * sizeof(int64_t));
        vbuf = malloc(OUT_CAP * sizeof(double));
        if (!outst || !kbuf || !vbuf) {
            free(ws); free(outst); free(kbuf); free(vbuf);
            return 1;
        }
        for (int64_t s = 0; s < n_sms; s++) {
            memset(outst[s].key, 0xff, sizeof(outst[s].key));
            outst[s].count = 0;
        }
    }

    int64_t heap_n = 0;
    int64_t div_w = n_warps > 1 ? n_warps : 1;
    for (int64_t w = 0; w < n_warps; w++) {
        next_i[w] = op_start[w];
        op_end[w] = op_start[w + 1];
        if (op_start[w] < op_start[w + 1]) {
            HeapEnt e = {0.0, w};
            heap_push(heap, &heap_n, e);
        }
    }

    int64_t offchip = 0, merged = 0, l1_hits = 0;

    while (heap_n) {
        HeapEnt e = heap_pop(heap, &heap_n);
        double ready_t = e.t;
        int64_t w = e.w;
        int64_t sm = w * n_sms / div_w;
        if (sm > n_sms - 1) sm = n_sms - 1;
        int64_t i = next_i[w];
        int64_t end = op_end[w];
        for (;;) {
            double free_t = issue_free[sm];
            double t_start = ready_t > free_t ? ready_t : free_t;
            double t_acc = t_start + (double)issue[i];
            issue_free[sm] = t_acc;
            double warp_ready;
            int8_t k = kind[i];
            if (k == 0) {                         /* compute */
                warp_ready = t_acc + depth;
            } else if (k == 1) {                  /* load */
                double done = t_acc + hit_lat;
                int64_t o = blk_off[i], l = blk_len[i];
                int64_t tick = tick_of[sm];
                for (int64_t bi = o; bi < o + l; bi++) {
                    int64_t block = blocks[bi];
                    /* L1 lookup (pending lines carry their fill time). */
                    tick++;
                    int64_t si = sm * n_sets + block % n_sets;
                    int64_t base = si * ways;
                    int64_t cnt = l1_count[si];
                    int64_t slot = -1;
                    for (int64_t wy = 0; wy < cnt; wy++) {
                        if (l1_block[base + wy] == block) { slot = base + wy; break; }
                    }
                    if (slot >= 0) {
                        l1_tick[slot] = tick;
                        if (l1_fill[slot] <= t_acc) { l1_hits++; continue; }
                    }
                    if (ideal) {
                        double *out_t = out_find(&outst[sm], block);
                        if (out_t && *out_t > t_acc) {
                            merged++;
                            if (*out_t > done) done = *out_t;
                            continue;
                        }
                    }
                    /* DRAM request (full 64 B read transaction). */
                    int64_t c = block % nctrl;
                    double cf = ctrl_free[c];
                    double start = cf > t_acc ? cf : t_acc;
                    ctrl_free[c] = start + svc_unit;
                    double completion = start + dram_lat + svc_unit;
                    offchip++;
                    /* L1 fill / pending-line allocation. */
                    tick++;
                    if (slot >= 0) {
                        l1_tick[slot] = tick;
                        if (completion < l1_fill[slot]) l1_fill[slot] = completion;
                    } else {
                        if (cnt >= ways) {        /* evict LRU (unique ticks) */
                            int64_t victim = base;
                            for (int64_t wy = 1; wy < cnt; wy++)
                                if (l1_tick[base + wy] < l1_tick[victim])
                                    victim = base + wy;
                            /* dict delete keeps other entries; emulate by
                             * moving the last entry into the hole.  Order
                             * inside a set never affects decisions (lookup
                             * is exact-match, eviction is by min tick). */
                            cnt--;
                            l1_block[victim] = l1_block[base + cnt];
                            l1_tick[victim] = l1_tick[base + cnt];
                            l1_fill[victim] = l1_fill[base + cnt];
                        }
                        l1_block[base + cnt] = block;
                        l1_tick[base + cnt] = tick;
                        l1_fill[base + cnt] = completion;
                        l1_count[si] = cnt + 1;
                    }
                    if (ideal) {
                        out_put(&outst[sm], block, completion);
                        if (outst[sm].count > 4096)
                            out_prune(&outst[sm], t_acc, kbuf, vbuf);
                        if (outst[sm].count > OUT_CAP / 2) {
                            /* Pruning could not shrink the table: more
                             * live in-flight blocks than this fixed-size
                             * map can hold without degrading.  Decline the
                             * workload; the caller falls back to the
                             * Python engine (unbounded dict), keeping
                             * results identical.  */
                            free(ws); free(outst); free(kbuf); free(vbuf);
                            return 2;
                        }
                    }
                    if (completion > done) done = completion;
                }
                tick_of[sm] = tick;
                warp_ready = done;
            } else {                              /* store: fire-and-forget */
                int64_t o = blk_off[i], l = blk_len[i];
                for (int64_t bi = o; bi < o + l; bi++) {
                    int64_t nb = nbytes[bi];
                    int64_t c = blocks[bi] % nctrl;
                    double svc = svc_unit * ((nb > 32 ? (double)nb : 32.0) / 64.0);
                    double cf = ctrl_free[c];
                    double start = cf > t_acc ? cf : t_acc;
                    ctrl_free[c] = start + svc;
                }
                offchip += l;
                warp_ready = t_acc + hit_lat;
            }
            i++;
            if (i == end) break;
            /* Peek: if this warp would be popped right back off the heap,
             * keep issuing it without the push/pop round trip.  Exact
             * equivalence: (warp_ready, w) precedes heap top in the
             * (time, warp) order iff the reference pops it next. */
            if (heap_n) {
                HeapEnt h0 = heap[0];
                if (warp_ready > h0.t || (warp_ready == h0.t && w > h0.w)) {
                    next_i[w] = i;
                    HeapEnt ne = {warp_ready, w};
                    heap_push(heap, &heap_n, ne);
                    break;
                }
            }
            ready_t = warp_ready;
        }
    }

    double cycles = 0.0;
    for (int64_t s = 0; s < n_sms; s++)
        if (issue_free[s] > cycles) cycles = issue_free[s];
    out[0] = cycles;
    out[1] = (double)offchip;
    out[2] = (double)merged;
    out[3] = (double)l1_hits;
    free(ws);
    if (ideal) { free(outst); free(kbuf); free(vbuf); }
    return 0;
}
