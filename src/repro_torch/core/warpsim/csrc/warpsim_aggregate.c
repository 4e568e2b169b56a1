/* Host C core of the warp-size study's aggregation (expansion phase 2).
 *
 * warpsim_aggregate replays a ThreadTrace event tape for one expansion
 * key (warp size, SIMD width, MIMD flag, transaction bytes) and emits the
 * WarpStream columns, ops grouped by warp, block pools in emission order:
 * the same columns, bit for bit, as the numpy pass of
 * divergence.aggregate_stream(impl="python"). Built with
 *     cc -O2 -fPIC -shared -ffp-contract=off -fno-fast-math
 * by _native.py and bound through ctypes. It runs on the host, beside the
 * family launches on the card.  */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* All-integer arithmetic and canonical ascending sort orders, so the
 * output is bit-identical to the numpy aggregation pass.  Event kinds: 0
 * compute, 1 load, 2 store, 3 MIMD fragment split, 4 loop-boundary
 * fragment reset.  Returns 0 on success, 1 on allocation failure.  */

/* Per-warp (frag, block) pair for the rare unpackable-key fallback. */
typedef struct { int64_t frag, block; } AggTxn;

static int agg_txn_cmp(const void *pa, const void *pb) {
    const AggTxn *a = (const AggTxn *)pa, *b = (const AggTxn *)pb;
    if (a->frag != b->frag) return a->frag < b->frag ? -1 : 1;
    if (a->block != b->block) return a->block < b->block ? -1 : 1;
    return 0;
}

/* Specialized ascending int64 sort for per-warp transaction keys (at most
 * warp_size elements): qsort's indirect comparator costs ~10x an inlined
 * compare and the per-event transaction sort dominates aggregation.
 * Insertion sort below 32 elements (adaptive: coalesced access patterns
 * arrive nearly sorted), median-of-three quicksort above, recursing on
 * the smaller partition.  The order is total and canonical, so
 * instability cannot matter (equal keys are identical).  */
static void agg_i64_sort(int64_t *a, int64_t n) {
    while (n > 32) {
        int64_t mid = n / 2;
        int64_t t;
        if (a[mid] < a[0]) { t = a[0]; a[0] = a[mid]; a[mid] = t; }
        if (a[n - 1] < a[0]) { t = a[0]; a[0] = a[n - 1]; a[n - 1] = t; }
        if (a[n - 1] < a[mid]) { t = a[mid]; a[mid] = a[n - 1]; a[n - 1] = t; }
        int64_t pivot = a[mid];
        int64_t i = 0, j = n - 1;
        for (;;) {
            while (a[i] < pivot) i++;
            while (a[j] > pivot) j--;
            if (i >= j) break;
            t = a[i]; a[i] = a[j]; a[j] = t;
            i++; j--;
        }
        j++;                      /* a[0..j) <= pivot <= a[j..n) */
        if (j < n - j) { agg_i64_sort(a, j); a += j; n -= j; }
        else { agg_i64_sort(a + j, n - j); n = j; }
    }
    for (int64_t i = 1; i < n; i++) {
        int64_t v = a[i];
        int64_t j = i - 1;
        while (j >= 0 && a[j] > v) { a[j + 1] = a[j]; j--; }
        a[j + 1] = v;
    }
}

/* x / d for non-negative x when d's power-of-two shift was precomputed
 * (warp size / transaction bytes / SIMD width are powers of two in every
 * real config; the division fallback keeps odd values correct).  */
static inline int64_t agg_div(int64_t x, int64_t d, int shift) {
    return shift >= 0 ? x >> shift : x / d;
}

static int agg_pow2_shift(int64_t v) {
    if (v <= 0 || (v & (v - 1))) return -1;
    int s = 0;
    while (((int64_t)1 << s) < v) s++;
    return s;
}

int warpsim_aggregate(
    int64_t n, int64_t ws, int64_t simd, int64_t mimd, int64_t tb,
    int64_t g_simt,
    int64_t n_ev,
    const int8_t  *ev_kind,      /* [n_ev] event tape                    */
    const int32_t *ev_mask,      /* [n_ev] mask row                      */
    const int64_t *ev_arg,       /* [n_ev] compute count / then-mask row */
    const int64_t *ev_addr,      /* [n_ev] address row of mem events     */
    int64_t n_masks,
    const int64_t *tid_off,      /* [n_masks+1] active-tid CSR offsets   */
    const int64_t *tid_cat,      /* ascending active tids per mask       */
    const int64_t *addr_off,     /* address-pool CSR offsets             */
    const int64_t *addr_vals,    /* active-thread byte addresses         */
    int64_t ops_bound,           /* caller-computed op-count upper bound */
    int64_t *o_warp, int64_t *o_issue, int64_t *o_tins, int8_t *o_kind,
    int64_t *o_maccs, int64_t *o_blk_off, int64_t *o_blen,
    int64_t *o_blocks, int64_t *o_nbytes,
    int64_t *o_op_start,         /* [n_warps+1] CSR row offsets          */
    int64_t *o_counts)           /* [2] -> n_ops, n_blocks               */
{
    int64_t n_warps = n / ws;
    int ws_sh = agg_pow2_shift(ws);
    int tb_sh = agg_pow2_shift(tb);
    int sd_sh = agg_pow2_shift(simd);

    /* Per-mask (active warp ids, per-warp counts) stats, lazily computed
     * into a prefix-offset arena (capacity min(n_warps, active)).  */
    int64_t stats_total = 0;
    size_t nm1 = (size_t)(n_masks > 0 ? n_masks : 1);
    int64_t *stat_off = malloc((nm1 + 1) * sizeof(int64_t));
    int64_t *stat_nw = malloc(nm1 * sizeof(int64_t));
    if (!stat_off || !stat_nw) { free(stat_off); free(stat_nw); return 1; }
    stat_off[0] = 0;
    for (int64_t m = 0; m < n_masks; m++) {
        int64_t cnt = tid_off[m + 1] - tid_off[m];
        int64_t cap = cnt < n_warps ? cnt : n_warps;
        stat_off[m + 1] = stat_off[m] + cap;
        stat_nw[m] = -1;
        stats_total += cap;
    }
    size_t ws_bytes =
        (size_t)stats_total * 2 * sizeof(int64_t) +  /* w/act arenas  */
        (size_t)n * sizeof(int64_t) +                /* frag_id       */
        (size_t)n_warps * 2 * sizeof(int64_t) +      /* stamp, nfc    */
        (size_t)ws * 2 * sizeof(int64_t) +           /* frag/key bufs */
        (size_t)ws * sizeof(AggTxn) +                /* fallback buf  */
        (size_t)ops_bound *
            (5 * sizeof(int64_t) + sizeof(int8_t)) + /* emission cols */
        (size_t)n_warps * sizeof(int64_t);           /* place cursor  */
    char *wsb = malloc(ws_bytes > 0 ? ws_bytes : 1);
    if (!wsb) { free(stat_off); free(stat_nw); return 1; }
    char *p = wsb;
    int64_t *w_arena = (int64_t *)p;  p += stats_total * sizeof(int64_t);
    int64_t *a_arena = (int64_t *)p;  p += stats_total * sizeof(int64_t);
    int64_t *frag_id = (int64_t *)p;  p += n * sizeof(int64_t);
    int64_t *stamp   = (int64_t *)p;  p += n_warps * sizeof(int64_t);
    int64_t *nfc     = (int64_t *)p;  p += n_warps * sizeof(int64_t);
    int64_t *fragbuf = (int64_t *)p;  p += ws * sizeof(int64_t);
    int64_t *keybuf  = (int64_t *)p;  p += ws * sizeof(int64_t);
    AggTxn  *txn     = (AggTxn *)p;   p += ws * sizeof(AggTxn);
    /* Emission-order op columns, counting-sorted into o_* at the end. */
    int64_t *e_warp  = (int64_t *)p;  p += ops_bound * sizeof(int64_t);
    int64_t *e_issue = (int64_t *)p;  p += ops_bound * sizeof(int64_t);
    int64_t *e_tins  = (int64_t *)p;  p += ops_bound * sizeof(int64_t);
    int64_t *e_maccs = (int64_t *)p;  p += ops_bound * sizeof(int64_t);
    int64_t *e_blen  = (int64_t *)p;  p += ops_bound * sizeof(int64_t);
    int8_t  *e_kind  = (int8_t *)p;   p += ops_bound * sizeof(int8_t);
    int64_t *cursor  = (int64_t *)p;
    memset(frag_id, 0, (size_t)n * sizeof(int64_t));
    memset(stamp, 0xff, (size_t)n_warps * sizeof(int64_t));

    int64_t n_ops = 0, n_blk = 0;
    for (int64_t e = 0; e < n_ev; e++) {
        int8_t k = ev_kind[e];
        int64_t m = ev_mask[e];
        if (k == 0 && stat_nw[m] < 0) {
            const int64_t *tv = tid_cat + tid_off[m];
            int64_t cnt = tid_off[m + 1] - tid_off[m];
            int64_t *wi = w_arena + stat_off[m];
            int64_t *ac = a_arena + stat_off[m];
            int64_t nw = 0;
            for (int64_t t = 0; t < cnt; t++) {
                int64_t w = agg_div(tv[t], ws, ws_sh);  /* ascending tids */
                if (nw && wi[nw - 1] == w) ac[nw - 1]++;
                else { wi[nw] = w; ac[nw] = 1; nw++; }
            }
            stat_nw[m] = nw;
        }
        if (k == 0) {                         /* compute */
            int64_t nw = stat_nw[m];
            const int64_t *wi = w_arena + stat_off[m];
            const int64_t *ac = a_arena + stat_off[m];
            int64_t count = ev_arg[e];
            for (int64_t j = 0; j < nw; j++) {
                e_warp[n_ops] = wi[j];
                e_issue[n_ops] = mimd
                    ? count * agg_div(ac[j] + simd - 1, simd, sd_sh)
                    : count * g_simt;
                e_tins[n_ops] = count * ac[j];
                e_kind[n_ops] = 0;
                e_maccs[n_ops] = 0;
                e_blen[n_ops] = 0;
                n_ops++;
            }
        } else if (k == 1 || k == 2) {        /* load / store */
            const int64_t *tv = tid_cat + tid_off[m];
            int64_t cnt = tid_off[m + 1] - tid_off[m];
            const int64_t *av = addr_vals + addr_off[ev_addr[e]];
            /* Active tids ascend, so each warp is one contiguous run:
             * transactions sort/dedup *per warp* (at most warp_size keys,
             * nearly sorted for coalesced patterns) instead of one global
             * pool sort — same canonical (warp, frag, block) order.  */
            int64_t t = 0;
            while (t < cnt) {
                int64_t w = agg_div(tv[t], ws, ws_sh);
                int64_t wend = (w + 1) * ws;
                int64_t t1 = t;
                while (t1 < cnt && tv[t1] < wend) t1++;
                int64_t len = t1 - t;         /* = active threads of warp */
                int64_t blen = 0;
                int pack = 1;
                if (mimd) {
                    /* Key = frag << 44 | block: ascending key order is
                     * the (frag, block) lexicographic order when frag
                     * fits 19 bits and block 44 (always, in practice). */
                    for (int64_t q = 0; q < len; q++) {
                        int64_t f = frag_id[tv[t + q]];
                        int64_t b = agg_div(av[t + q], tb, tb_sh);
                        if (f < 0 || f >= ((int64_t)1 << 19)
                            || b >= ((int64_t)1 << 44)) { pack = 0; break; }
                        keybuf[q] = (f << 44) | b;
                    }
                } else {
                    for (int64_t q = 0; q < len; q++)
                        keybuf[q] = agg_div(av[t + q], tb, tb_sh);
                }
                if (pack) {
                    agg_i64_sort(keybuf, len);
                    int64_t mask44 = ((int64_t)1 << 44) - 1;
                    int64_t q = 0;
                    while (q < len) {
                        int64_t key = keybuf[q];
                        int64_t mult = 0;
                        while (q < len && keybuf[q] == key) { mult++; q++; }
                        int64_t nb = mult * 4;
                        o_blocks[n_blk] = mimd ? (key & mask44) : key;
                        o_nbytes[n_blk] = nb < tb ? nb : tb;
                        n_blk++;
                        blen++;
                    }
                } else {                      /* unpackable: struct sort */
                    for (int64_t q = 0; q < len; q++) {
                        txn[q].frag = frag_id[tv[t + q]];
                        txn[q].block = agg_div(av[t + q], tb, tb_sh);
                    }
                    qsort(txn, (size_t)len, sizeof(AggTxn), agg_txn_cmp);
                    int64_t q = 0;
                    while (q < len) {
                        int64_t f = txn[q].frag, b = txn[q].block;
                        int64_t mult = 0;
                        while (q < len && txn[q].frag == f
                               && txn[q].block == b) { mult++; q++; }
                        int64_t nb = mult * 4;
                        o_blocks[n_blk] = b;
                        o_nbytes[n_blk] = nb < tb ? nb : tb;
                        n_blk++;
                        blen++;
                    }
                }
                e_warp[n_ops] = w;
                e_issue[n_ops] = mimd
                    ? agg_div(len + simd - 1, simd, sd_sh) : g_simt;
                e_tins[n_ops] = len;
                e_kind[n_ops] = k;
                e_maccs[n_ops] = len;
                e_blen[n_ops] = blen;
                n_ops++;
                t = t1;
            }
        } else if (k == 3) {                  /* MIMD fragment split */
            if (!mimd) continue;
            const int64_t *tv = tid_cat + tid_off[m];
            int64_t cnt = tid_off[m + 1] - tid_off[m];
            int64_t m2 = ev_arg[e];
            const int64_t *thv = tid_cat + tid_off[m2];
            int64_t thc = tid_off[m2 + 1] - tid_off[m2];
            int64_t pp = 0;
            for (int64_t t = 0; t < cnt; t++) {
                int64_t tid = tv[t];
                int64_t w = agg_div(tid, ws, ws_sh);
                if (stamp[w] != e) {
                    /* Distinct pre-split fragments of warp w; tids of one
                     * warp are contiguous in tv, so nfc[w] is computed
                     * before any of w's threads update below.  */
                    stamp[w] = e;
                    memcpy(fragbuf, frag_id + w * ws,
                           (size_t)ws * sizeof(int64_t));
                    agg_i64_sort(fragbuf, ws);
                    int64_t nf = 1;
                    for (int64_t q = 1; q < ws; q++)
                        if (fragbuf[q] != fragbuf[q - 1]) nf++;
                    nfc[w] = nf;
                }
                /* then-mask is a subset of mask; both tid lists ascend,
                 * so membership (= branch outcome) is a merge scan.  */
                while (pp < thc && thv[pp] < tid) pp++;
                int64_t outcome = (pp < thc && thv[pp] == tid);
                if (nfc[w] < 4)
                    frag_id[tid] = frag_id[tid] * 2 + outcome;
            }
        } else {                              /* k == 4: fragment reset */
            if (!mimd) continue;
            const int64_t *tv = tid_cat + tid_off[m];
            int64_t cnt = tid_off[m + 1] - tid_off[m];
            for (int64_t t = 0; t < cnt; t++) frag_id[tv[t]] = 0;
        }
    }

    /* Emission-order block-pool offsets, then stable counting sort by
     * warp into the outputs — the exact layout of numpy's
     * argsort(kind="stable") + searchsorted CSR assembly.  */
    memset(cursor, 0, (size_t)n_warps * sizeof(int64_t));
    for (int64_t i = 0; i < n_ops; i++) cursor[e_warp[i]]++;
    o_op_start[0] = 0;
    for (int64_t w = 0; w < n_warps; w++) {
        o_op_start[w + 1] = o_op_start[w] + cursor[w];
        cursor[w] = o_op_start[w];
    }
    int64_t boff = 0;
    for (int64_t i = 0; i < n_ops; i++) {
        int64_t pos = cursor[e_warp[i]]++;
        o_warp[pos] = e_warp[i];
        o_issue[pos] = e_issue[i];
        o_tins[pos] = e_tins[i];
        o_kind[pos] = e_kind[i];
        o_maccs[pos] = e_maccs[i];
        o_blen[pos] = e_blen[i];
        o_blk_off[pos] = boff;
        boff += e_blen[i];
    }
    o_counts[0] = n_ops;
    o_counts[1] = n_blk;
    free(wsb);
    free(stat_off);
    free(stat_nw);
    return 0;
}
