// Trace-family timing core of the warp-size study, as code that compiles
// both for the card (nvcc, sm_90a) and for the host (g++, the CPU tests).
//
// Replaces the TPU device program src/repro/core/warpsim/_pallas.py:
//   K1  _get_launch._prep_kernel (pallas_call in _prep, _pallas.py:192-229)
//       -> ws_prep_block, folded into K2: the lanes of ws_family_kernel run
//       it on the blocks they stage. ws_prep_kernel runs it alone, per
//       (unit, block), as the entry that checks it on the card; the study
//       never launches it;
//   K2  _get_launch._simulate_one (lax.while_loop vmapped over units,
//       _pallas.py:233-407) -> ws_simulate_unit, one warp per unit in
//       ws_family_kernel. One launch of it simulates a family.
//
// Bit-identity with the reference engines rests on doing the same IEEE-754
// double operations in the same order: build with --fmad=false (nvcc) or
// -ffp-contract=off (g++), since one contracted multiply-add changes the
// last bit of a cycle count.
//
// What bounds it on the card: K2 is latency-bound, not bound by bytes or
// operations. Each unit is one dependent chain through simulated time (pop
// the earliest warp, issue one op, update the L1/DRAM state the next op
// reads), so its time is the number of steps times the latency of one
// step, and one warp alone on an SM hides none of it: every dependent
// instruction costs its whole latency. The design shortens the step:
//   - one warp per unit. Every lane runs the scalar recurrence redundantly
//     (the same double operations, so the values stay warp-uniform in
//     registers), and the lanes work together only where a step searches
//     or fetches:
//     - the pop: each lane keeps the first minimum of its own warps w =
//       lane, lane + 32, ... (their ready times in registers, up to 256
//       warps a unit), updated only by the lane whose warp changed; three
//       32-bit warp reductions of an order-preserving key of the time and
//       the warp then give the least time, lowest warp on ties: heapq's
//       (time, warp) order. Above 256 warps the ready times stay in the
//       state, in bands of 256 consecutive warps, and the lanes keep
//       bands' first minima in those registers instead. Up to 8 bands
//       (2,048 warps) each lane keeps its own part of every band, and a
//       step has the changed warp's lane read its part again, one round of
//       8 loads; above, a lane keeps whole bands (up to 256), and a step
//       has every lane read the changed warp's band again, one coalesced
//       round of 8 loads a lane, combined by three more reductions;
//     - the way search: lane y tests way y; the first hit, whether its
//       line is filled by now, and the first empty way come from ballots;
//       the LRU victim (least tick, lowest way on ties) from two more
//       reductions;
//     - the blocks of the op: the lanes copy up to 32 blocks' ids (and a
//       load's slots or a store's byte counts) into a shared stage at once
//       (cp.async), as soon as the warp is popped, and each lane preps its
//       own block (K1) once the copies have landed;
//   - the state in shared memory where a unit's state fits a block's 227
//     KB, else in global scratch (the "shared" and "global" placements of
//     ws_family_kernel, picked per launch by the wrapper);
//   - each warp's next op fetched one step of that warp ahead, its SM
//     computed once, its state read as one 32-byte record, and indices,
//     tags and LRU ticks in 32 bits (host-checked).
// Nothing in the searches does floating-point arithmetic, so any correct
// reduction gives the reference's answer; what must hold is the tie rule.
// The searches and fetches have two forms over one lane-partitioned
// layout: WsWarpLanes (shuffles, ballots and cp.async, on the card) and
// WsHostLanes (the same lanes walked one after another, for the CPU tests'
// g++ build).
// K1 alone is a map bound by its bytes, too little work to pay for a launch
// of its own, and K2 read its output back. Folded in, the lanes that stage
// an op's blocks turn each block id into its memory controller and L1 set
// (b % nctrl, b % n_sets, by a multiply-high: no division on the chain) and
// a store's byte count into its occupancy, in parallel, before the step
// reads them. That conversion does lie on the chain, once per 32 blocks of
// a memory op: prepping each warp's next op a step ahead into its state
// was faster only where the state lies in shared memory, and slower in
// global scratch (PERF.md, section 6).
#pragma once

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#define WS_HD __host__ __device__
// The step body is one template for both forms of the searches; each
// instantiation calls only the functions of its own side.
#define WS_HD_TEMPLATE _Pragma("nv_exec_check_disable")
#else
#define WS_HD
#define WS_HD_TEMPLATE
#endif

// Columns of the per-unit int64 parameter table `up` [units, WS_NI]. The
// order is shared with UP_COLS in _cuda.py.
enum {
    WS_WARP_OFF = 0,  // first warp of the unit in next0 / end
    WS_OP_OFF,        // first op of the unit in issue / kind / blk_off / blk_len
    WS_BLK_OFF,       // first block of the unit in blocks / nbytes / slot
    WS_N_WARPS,
    WS_N_BLOCKS,
    WS_N_SMS,
    WS_NCTRL,         // memory controllers
    WS_N_SETS,        // L1 sets: l1_size_bytes / (transaction_bytes * l1_ways)
    WS_WAYS,
    WS_IDEAL,         // SW+ ideal coalescing (1) or not (0)
    WS_N_SLOTS,       // unique blocks of the stream: width of the outstanding table
    WS_SMALL_OFF,     // first word of the unit's small state in the global scratch
    WS_BIG_OFF,       // first word of the unit's L1 and SW+ state in the scratch
    WS_CTRL_MUL,      // multiply-high constant of nctrl (uint64 bits; ws_mod)
    WS_CTRL_SHIFT,    // ... and its shift
    WS_SETS_MUL,      // the same for n_sets
    WS_SETS_SHIFT,
    WS_NI
};

// Columns of the per-unit double parameter table `fp` [units, WS_NF]
// (FP_COLS in _cuda.py).
enum { WS_HIT_LAT = 0, WS_DEPTH, WS_DRAM_LAT, WS_SVC, WS_NF };

// Lanes of the warp that simulates one unit, and the warps of the unit
// each lane keeps in registers.
constexpr int WS_LANES = 32;
constexpr int WS_K = 8;

// Above WS_K * WS_LANES warps a unit's ready times stay in its state and
// are read in bands of consecutive warps. Up to WS_K bands (2,048 warps),
// register b of lane l holds the first minimum of lane l's own warps of
// band b (ws_lane_parts). Above, 256 warps a band up to 65,536 warps, so
// that the lanes' WS_K registers hold every band's first minimum (band b
// in register b / WS_LANES of lane b % WS_LANES); above, bands of 256 *
// ws_band_rounds(nw) warps, read in that many rounds, so that a unit never
// has more than 256 bands.
WS_HD inline bool ws_lane_parts(int nw) {
    return nw <= WS_K * WS_K * WS_LANES;
}
WS_HD inline int ws_band_rounds(int nw) {
    const int most = WS_K * WS_LANES * WS_K * WS_LANES;
    return (nw + most - 1) / most;
}
WS_HD inline int ws_band_of(int w, int rounds) {
    const int b = w / (WS_K * WS_LANES);
    return rounds > 1 ? b / rounds : b;
}

// A divisor d (1 <= d < 2^31) with its multiply-high constants: l =
// ceil(log2 d) and m = ceil(2^(63+l) / d) (marshal() in _cuda.py). Then
// 2^(63+l) <= m d <= 2^(63+l) + 2^l, so floor(b / d) = floor(m b / 2^(63+l))
// for every 0 <= b < 2^63 (Granlund and Montgomery 1994, theorem 4.2), and
// m < 2^64 (m = 2^63 for a power of two, d = 1 included): the quotient is
// the high word of the 64-bit product of 2b and m, shifted right by l, with
// no 65th bit.
struct WsDiv {
    int64_t d;
    uint64_t m;
    int l;
};

WS_HD inline WsDiv ws_div(const int64_t *p, int d, int m, int l) {
    return WsDiv{p[d], (uint64_t)p[m], (int)p[l]};
}

// b % v.d for 0 <= b < 2^63. The remainder is below 2^31, so it is exact
// in 32 bits.
WS_HD inline int64_t ws_mod(int64_t b, WsDiv v) {
    const uint64_t b2 = (uint64_t)b << 1;
#ifdef __CUDA_ARCH__
    const uint64_t hi = __umul64hi(b2, v.m);
#else
    const uint64_t hi = (uint64_t)(((unsigned __int128)b2 * v.m) >> 64);
#endif
    return (int64_t)(uint32_t)((uint32_t)b - (uint32_t)(hi >> v.l) *
                                                 (uint32_t)v.d);
}

// A store's occupancy of its controller: a minimum 32 B burst, divided
// before it is multiplied, exactly svc * (max(nbytes, 32) / 64.0) as the
// reference computes it.
WS_HD inline double ws_store_svc(double svc, int64_t nbytes) {
    return svc * ((double)(nbytes > 32 ? nbytes : 32) / 64.0);
}

// K1 for one block: memory controller, L1 set and store occupancy.
WS_HD inline void ws_prep_block(int64_t block, int64_t nbytes, WsDiv nctrl,
                                WsDiv n_sets, double svc, int64_t *ctrl,
                                int64_t *si, double *ssvc) {
    *ctrl = ws_mod(block, nctrl);
    *si = ws_mod(block, n_sets);
    *ssvc = ws_store_svc(svc, nbytes);
}

// K1 for block j of unit u of a family (all pointers are family bases).
WS_HD inline void ws_prep_unit_block(int64_t u, int64_t j, const int64_t *up,
                                     const double *fp, const int64_t *blocks,
                                     const int64_t *nbytes, int64_t *ctrl,
                                     int64_t *si, double *ssvc) {
    const int64_t *p = up + u * WS_NI;
    const int64_t b = p[WS_BLK_OFF] + j;
    ws_prep_block(blocks[b], nbytes[b],
                  ws_div(p, WS_NCTRL, WS_CTRL_MUL, WS_CTRL_SHIFT),
                  ws_div(p, WS_N_SETS, WS_SETS_MUL, WS_SETS_SHIFT),
                  fp[u * WS_NF + WS_SVC], &ctrl[b], &si[b], &ssvc[b]);
}

// The state of one warp of a unit: where it is in its ops, its SM, and the
// columns of its next op, fetched one step of that warp ahead. Indices
// within a unit are int32: marshal() checks that a unit's ops, blocks
// (twice over, for the LRU ticks), slots and L1 lines each stay below 2^31.
struct alignas(16) WsWarp {
    int64_t issue;            // issue cycles of the warp's next op
    int32_t next, end, sm;    // its next op, one past its last op, its SM
    int32_t kind, off, len;   // the next op's kind and blocks
};
static_assert(sizeof(WsWarp) == 32, "four int64s a warp in the state");

// A unit's state, in 8-byte words, in two parts (marshal() in _cuda.py
// sizes them the same way):
//   small: warps[n_warps] (WsWarp, 4 words each), then f64 ready[n_warps]
//          issue_free[n_sms] ctrl_free[nctrl], then int32 tick_ctr[n_sms],
//          padded to an even count of words;
//   big:   f64 fills[n_sms*n_sets*ways] outstanding[ideal ? n_sms*n_slots
//          : 0], then int32 tags[n_sms*n_sets*ways] ticks[n_sms*n_sets*ways]
//          (the L1 lines and the SW+ table).
// Tags (slot ids) and LRU ticks (at most two a block) are narrower than the
// reference's int64, as marshal() checks that both fit. In the launch's
// placement "shared" both parts lie in shared memory, small first; in
// "global" at the unit's offsets (WS_SMALL_OFF, WS_BIG_OFF) in the global
// scratch.
WS_HD inline int64_t ws_lines(const int64_t *p) {
    return p[WS_N_SMS] * p[WS_N_SETS] * p[WS_WAYS];
}
WS_HD inline int64_t ws_small_len(const int64_t *p) {
    const int64_t n = 5 * p[WS_N_WARPS] + p[WS_N_SMS] + p[WS_NCTRL] +
                      (p[WS_N_SMS] + 1) / 2;
    return n + (n & 1);
}

// Up to 32 blocks of the op being issued. The lanes fetch them together,
// then each lane turns its own block, in place, into what the step reads
// (K1): `block` from the block id into its memory controller, and `word`
// into a load's L1 set or from a store's byte count into its occupancy.
union WsWord {
    int64_t i;
    double d;
};
struct WsStage {
    int64_t slot[WS_LANES], block[WS_LANES];
    WsWord word[WS_LANES];
};

// (t, w) comes before (t2, w2): the least time, the lowest id on ties.
template <typename T>
WS_HD inline bool ws_before(T t, int64_t w, T t2, int64_t w2) {
    return t < t2 || (t == t2 && w < w2);
}

// Host form of the searches: lane l of the device form is the l-th pass of
// a loop here, over the same layout (lane l owns warps l, l + 32, ... and
// tests ways l, l + 32, ...).
struct WsHostLanes {
    double lt[WS_LANES];    // lane l's first minimum of its warps' ready
    int64_t lw[WS_LANES];   // ... and its warp, -1 when all are inf
    // Above 256 warps: lane l's first minima of its parts of bands 0, 1,
    // ... (up to 2,048 warps), else of bands l, l + 32, ..., and their
    // warps (-1 when all are inf); lt, lw are then the first of them.
    double bt[WS_LANES][WS_K];
    int64_t bw[WS_LANES][WS_K];

    int first() const { return 0; }
    int stride() const { return 1; }
    void sync() {}
    // f(x) for x < n (n <= 32): the lanes' items, one after another.
    template <class F> void each(int n, F &&f) const {
        for (int x = 0; x < n; x++) f(x);
    }
    template <typename T> void fetch(T *dst, const T *src) const { *dst = *src; }
    void fetched() const {}

    void refresh_lane(int l, const double *ready, int nw) {
        double t = INFINITY;
        int64_t w = -1;
        for (int j = l; j < nw; j += WS_LANES)
            if (ready[j] < t) {
                t = ready[j];
                w = j;
            }
        lt[l] = t;
        lw[l] = w;
    }
    // Band b's first minimum into its lane's register: pass l reads what
    // lane l reads (the band's warps l, l + 32, ...), and the passes'
    // minima combine as the lanes' reductions do.
    void band(const double *ready, int nw, int rounds, int b) {
        const int j0 = b * rounds * WS_K * WS_LANES;
        const int span = rounds * WS_K * WS_LANES;
        const int j1 = nw - j0 < span ? nw : j0 + span;
        double t = INFINITY;
        int64_t w = -1;
        for (int l = 0; l < WS_LANES; l++) {
            double tl = INFINITY;
            int64_t wl = -1;
            for (int j = j0 + l; j < j1; j += WS_LANES)
                if (ready[j] < tl) {
                    tl = ready[j];
                    wl = j;
                }
            if (ws_before(tl, wl, t, w)) {
                t = tl;
                w = wl;
            }
        }
        bt[b % WS_LANES][b / WS_LANES] = t;
        bw[b % WS_LANES][b / WS_LANES] = w;
    }
    // Lane l's part of band b (its warps b * 256 + l, + 32, ...) into its
    // register b, as lane l reads it (up to 2,048 warps).
    void part(const double *ready, int nw, int l, int b) {
        const int j1 = nw < (b + 1) * WS_K * WS_LANES ? nw
                                                      : (b + 1) * WS_K * WS_LANES;
        double t = INFINITY;
        int64_t w = -1;
        for (int j = b * WS_K * WS_LANES + l; j < j1; j += WS_LANES)
            if (ready[j] < t) {
                t = ready[j];
                w = j;
            }
        bt[l][b] = t;
        bw[l][b] = w;
    }
    // Lane l's first minimum of its bands: the lower band wins ties.
    void bands_min(int l) {
        double t = INFINITY;
        int64_t w = -1;
        for (int k = 0; k < WS_K; k++)
            if (bt[l][k] < t) {
                t = bt[l][k];
                w = bw[l][k];
            }
        lt[l] = t;
        lw[l] = w;
    }
    void start(const double *ready, int nw) {
        if (nw > WS_K * WS_LANES) {
            const int rounds = ws_band_rounds(nw);
            for (int l = 0; l < WS_LANES; l++)
                for (int k = 0; k < WS_K; k++) {
                    bt[l][k] = INFINITY;
                    bw[l][k] = -1;
                }
            for (int b = 0; b * rounds * WS_K * WS_LANES < nw; b++) {
                if (ws_lane_parts(nw))
                    for (int l = 0; l < WS_LANES; l++) part(ready, nw, l, b);
                else
                    band(ready, nw, rounds, b);
            }
            for (int l = 0; l < WS_LANES; l++) bands_min(l);
            return;
        }
        for (int l = 0; l < WS_LANES; l++) refresh_lane(l, ready, nw);
    }
    // ready[w] changed (to the value it now holds): only its lane's
    // minimum can have moved; above 256 warps, only its lane's part of its
    // band, or above 2,048 warps its band's, held by one lane.
    void changed(const double *ready, int nw, int w, double) {
        if (nw > WS_K * WS_LANES) {
            if (ws_lane_parts(nw)) {
                part(ready, nw, w % WS_LANES, w / (WS_K * WS_LANES));
                bands_min(w % WS_LANES);
                return;
            }
            const int rounds = ws_band_rounds(nw);
            const int b = ws_band_of(w, rounds);
            band(ready, nw, rounds, b);
            bands_min(b % WS_LANES);
            return;
        }
        refresh_lane(w % WS_LANES, ready, nw);
    }
    // The first minimum of ready over all warps; -1 when every warp is inf.
    int pop(double *t_out) const {
        double t = lt[0];
        int64_t w = lw[0];
        for (int l = 1; l < WS_LANES; l++)
            if (ws_before(lt[l], lw[l], t, w)) {
                t = lt[l];
                w = lw[l];
            }
        *t_out = t;
        return (int)w;
    }
    // The first way of a set (tags and fills at its row) that holds slot
    // s, else -1; *fresh whether that way's line is filled by time t;
    // *empty the first way that holds nothing (-1 if none), valid when no
    // way holds s.
    static int find_way(const int32_t *tags, const double *fills, int ways,
                        int s, double t, int *empty, bool *fresh) {
        *empty = -1;
        *fresh = false;
        for (int y0 = 0; y0 < ways; y0 += WS_LANES) {
            uint32_t hit = 0, filled = 0, free_ways = 0;
            for (int l = 0; l < WS_LANES; l++) {
                const int y = y0 + l;
                const int tag = y < ways ? tags[y] : -2;
                hit |= (uint32_t)(tag == s) << l;
                filled |= (uint32_t)(tag == s && fills[y] <= t) << l;
                free_ways |= (uint32_t)(tag == -1) << l;
            }
            if (*empty < 0 && free_ways) *empty = y0 + __builtin_ctz(free_ways);
            if (hit) {
                const int l = __builtin_ctz(hit);
                *fresh = (filled >> l) & 1;
                return y0 + l;
            }
        }
        return -1;
    }
    // The LRU way of a full set: the least tick, the lowest way on ties.
    static int victim(const int32_t *ticks, int ways) {
        int64_t bt = INT64_MAX, bw = INT64_MAX;
        for (int l = 0; l < WS_LANES && l < ways; l++) {
            int64_t t = ticks[l], w = l;
            for (int y = l + WS_LANES; y < ways; y += WS_LANES)
                if (ticks[y] < t) {
                    t = ticks[y];
                    w = y;
                }
            if (ws_before(t, w, bt, bw)) {
                bt = t;
                bw = w;
            }
        }
        return (int)bw;
    }
};

#ifdef __CUDACC__
// Device form of the searches and fetches: lane l of the unit's warp holds
// what lane l of WsHostLanes holds; ballots, shuffles and warp reductions
// combine the lanes, and cp.async copies an op's blocks.
struct WsWarpLanes {
    static constexpr unsigned ALL = 0xffffffffu;
    double lt;   // this lane's first minimum of its warps' ready
    int lw;      // ... and its warp, -1 when all are inf
    unsigned key_hi, key_lo;  // lt as an unsigned key of the same order
    // Ready times of warps lane, lane + 32, ... (up to 256 warps); above,
    // the first minima of this lane's parts of bands 0, 1, ... (up to
    // 2,048 warps), else of bands lane, lane + 32, ..., and their warps
    // (-1 when all are inf).
    double v[WS_K];
    int vw[WS_K];
    int lane;

    __device__ WsWarpLanes()
        : lt(INFINITY), lw(-1), lane(threadIdx.x % WS_LANES) {}

    // Keys order as the doubles do (no NaN reaches the ready times): the
    // sign bit flipped for t >= 0, every bit for t < 0, and -0 keyed as +0
    // since the two compare equal.
    __device__ static unsigned long long key_of(double t) {
        const unsigned long long b =
            (unsigned long long)__double_as_longlong(t == 0.0 ? 0.0 : t);
        return (b >> 63) ? ~b : b | 0x8000000000000000ull;
    }
    // The time of a key: key_of undone (the ready times are never -0).
    __device__ static double key_time(unsigned hi, unsigned lo) {
        const unsigned long long k = (unsigned long long)hi << 32 | lo;
        return __longlong_as_double(
            (long long)((k >> 63) ? k ^ 0x8000000000000000ull : ~k));
    }
    __device__ void set_key() {
        const unsigned long long k = key_of(lt);
        key_hi = (unsigned)(k >> 32);
        key_lo = (unsigned)k;
    }
    __device__ int first() const { return lane; }
    __device__ int stride() const { return WS_LANES; }
    __device__ void sync() { __syncwarp(); }
    // f(x) for x < n (n <= 32): lane x does item x.
    template <class F> __device__ void each(int n, F &&f) const {
        if (lane < n) f(lane);
    }
    // 8 bytes from global memory into the stage, in shared memory, without
    // waiting: the copy overlaps what the step does before fetched().
    // fetched() waits for this lane's own copies; sync() then shares them.
    template <typename T>
    __device__ void fetch(T *dst, const T *src) const {
        static_assert(sizeof(T) == 8, "the stage holds 8-byte columns");
        const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                     "l"(src)
                     : "memory");
    }
    __device__ void fetched() const {
        asm volatile("cp.async.wait_all;\n" ::: "memory");
    }

    // The first minimum of v (warps w0, w0 + 32, ...): a tree of compares,
    // the left operand (the lower warp) winning ties.
    __device__ static void tree_min(double (&v)[WS_K], int w0, double *t,
                                    int *w) {
        double u[WS_K];
        int uw[WS_K];
#pragma unroll
        for (int k = 0; k < WS_K; k++) {
            u[k] = v[k];
            uw[k] = w0 + k * WS_LANES;
        }
#pragma unroll
        for (int h = 1; h < WS_K; h *= 2)
#pragma unroll
            for (int k = 0; k < WS_K; k += 2 * h)
                if (u[k + h] < u[k]) {
                    u[k] = u[k + h];
                    uw[k] = uw[k + h];
                }
        *t = u[0];
        *w = u[0] < INFINITY ? uw[0] : -1;
    }
    // The first minimum of this lane's warps, their ready times loaded into
    // its registers (v), WS_K loads in flight at once.
    __device__ void scan(const double *ready, int nw) {
        double t = INFINITY;
        int w = -1;
        for (int j0 = lane; j0 < nw; j0 += WS_K * WS_LANES) {
#pragma unroll
            for (int k = 0; k < WS_K; k++)
                v[k] = j0 + k * WS_LANES < nw ? ready[j0 + k * WS_LANES]
                                              : INFINITY;
            double tj;
            int wj;
            tree_min(v, j0, &tj, &wj);
            if (tj < t) {
                t = tj;
                w = wj;
            }
        }
        lt = t;
        lw = w;
        set_key();
    }
    // This lane's part of band b (its warps b * 256 + lane, + 32, ...):
    // its first minimum into register b, a round of WS_K loads, warp w
    // taken as ready at t without a load (w < 0: none).
    __device__ void part(const double *ready, int nw, int b, int w,
                         double t) {
        const int j0 = b * WS_K * WS_LANES + lane;
        double u[WS_K];
#pragma unroll
        for (int k = 0; k < WS_K; k++) {
            const int j = j0 + k * WS_LANES;
            u[k] = j == w ? t : j < nw ? ready[j] : INFINITY;
        }
        double tp;
        int wp;
        tree_min(u, j0, &tp, &wp);
#pragma unroll
        for (int k = 0; k < WS_K; k++)
            if (k == b) {
                v[k] = tp;
                vw[k] = wp;
            }
    }
    // Band b's first minimum, by every lane, into register b / WS_LANES of
    // lane b % WS_LANES: a round of WS_K coalesced loads a lane (rounds of
    // them in bands wider than 256 warps), each lane's tree of compares,
    // then the lanes' minima combined as pop() combines them. Warp w is
    // taken as ready at t without a load (w < 0: none). Lane l reads only
    // warps l, l + 32, ..., whose ready times it stored itself, so the
    // loads need no fence in either placement.
    __device__ void band(const double *ready, int nw, int rounds, int b,
                         int w, double t) {
        double bt = INFINITY;
        int bw = -1;
        for (int r = 0; r < rounds; r++) {
            const int j0 = (b * rounds + r) * WS_K * WS_LANES + lane;
            double u[WS_K];
#pragma unroll
            for (int k = 0; k < WS_K; k++) {
                const int j = j0 + k * WS_LANES;
                u[k] = j == w ? t : j < nw ? ready[j] : INFINITY;
            }
            double tr;
            int wr;
            tree_min(u, j0, &tr, &wr);
            if (tr < bt) {
                bt = tr;
                bw = wr;
            }
        }
        const unsigned long long k = key_of(bt);
        const unsigned hi = __reduce_min_sync(ALL, (unsigned)(k >> 32));
        const unsigned lo = __reduce_min_sync(
            ALL, (unsigned)(k >> 32) == hi ? (unsigned)k : 0xffffffffu);
        const int wb = (int)__reduce_min_sync(
            ALL, (unsigned)(k >> 32) == hi && (unsigned)k == lo
                     ? (unsigned)bw : 0xffffffffu);
        if ((b & (WS_LANES - 1)) != lane) return;
        const double tb = key_time(hi, lo);
        const int kb = b / WS_LANES;
#pragma unroll
        for (int k2 = 0; k2 < WS_K; k2++)
            if (k2 == kb) {
                v[k2] = tb;
                vw[k2] = wb;
            }
    }
    // lt, lw: the first minimum of this lane's bands, a tree of compares
    // with the lower band winning ties.
    __device__ void bands_min() {
        double u[WS_K];
        int uw[WS_K];
#pragma unroll
        for (int k = 0; k < WS_K; k++) {
            u[k] = v[k];
            uw[k] = vw[k];
        }
#pragma unroll
        for (int h = 1; h < WS_K; h *= 2)
#pragma unroll
            for (int k = 0; k < WS_K; k += 2 * h)
                if (u[k + h] < u[k]) {
                    u[k] = u[k + h];
                    uw[k] = uw[k + h];
                }
        lt = u[0];
        lw = uw[0];
        set_key();
    }
    __device__ void start(const double *ready, int nw) {
        if (nw > WS_K * WS_LANES) {
            const int rounds = ws_band_rounds(nw);
#pragma unroll
            for (int k = 0; k < WS_K; k++) {
                v[k] = INFINITY;
                vw[k] = -1;
            }
            for (int b = 0; b * rounds * WS_K * WS_LANES < nw; b++) {
                if (ws_lane_parts(nw))
                    part(ready, nw, b, -1, 0.0);
                else
                    band(ready, nw, rounds, b, -1, 0.0);
            }
            bands_min();
            return;
        }
        scan(ready, nw);
    }
    // ready[w] changed to t: only its lane's minimum can have moved, and
    // that lane alone updates it. Above 256 warps that lane reads its part
    // of w's band again; above 2,048 every lane reads w's band again, and
    // the lane that holds the band updates its minimum.
    __device__ void changed(const double *ready, int nw, int w, double t) {
        if (nw > WS_K * WS_LANES) {
            if (ws_lane_parts(nw)) {
                if ((w & (WS_LANES - 1)) != lane) return;
                part(ready, nw, w / (WS_K * WS_LANES), w, t);
                bands_min();
                return;
            }
            const int rounds = ws_band_rounds(nw);
            const int b = ws_band_of(w, rounds);
            band(ready, nw, rounds, b, w, t);
            if ((b & (WS_LANES - 1)) == lane) bands_min();
            return;
        }
        if ((w & (WS_LANES - 1)) != lane) return;
        const int kw = w / WS_LANES;
#pragma unroll
        for (int k = 0; k < WS_K; k++)
            if (k == kw) v[k] = t;
        tree_min(v, lane, &lt, &lw);
        set_key();
    }
    // Three warp reductions of 32-bit keys: the high half of the least
    // time, its low half, then the lowest warp holding it (-1, all bits
    // set, only when every time is inf). The time itself is the least
    // key's: above 2,048 warps the lane that holds a warp's band need not
    // be the lane of the warp.
    __device__ int pop(double *t_out) const {
        const unsigned hi = __reduce_min_sync(ALL, key_hi);
        const unsigned lo =
            __reduce_min_sync(ALL, key_hi == hi ? key_lo : 0xffffffffu);
        const int w = (int)__reduce_min_sync(
            ALL, key_hi == hi && key_lo == lo ? (unsigned)lw : 0xffffffffu);
        *t_out = key_time(hi, lo);
        return w;
    }
    __device__ int find_way(const int32_t *tags, const double *fills,
                            int ways, int s, double t, int *empty,
                            bool *fresh) const {
        *empty = -1;
        *fresh = false;
        for (int y0 = 0; y0 < ways; y0 += WS_LANES) {
            const int y = y0 + lane;
            const int tag = y < ways ? tags[y] : -2;
            const double fill = y < ways ? fills[y] : 0.0;
            const unsigned hit = __ballot_sync(ALL, tag == s);
            const unsigned filled = __ballot_sync(ALL, tag == s && fill <= t);
            const unsigned free_ways = __ballot_sync(ALL, tag == -1);
            if (*empty < 0 && free_ways) *empty = y0 + __ffs(free_ways) - 1;
            if (hit) {
                const int l = __ffs(hit) - 1;
                *fresh = (filled >> l) & 1;
                return y0 + l;
            }
        }
        return -1;
    }
    // Ticks are never negative, so two 32-bit reductions do: the least
    // tick, then the lowest way holding it.
    __device__ int victim(const int32_t *ticks, int ways) const {
        unsigned t = 0xffffffffu, w = 0xffffffffu;
        if (lane < ways) {
            t = (unsigned)ticks[lane];
            w = lane;
            for (int y = lane + WS_LANES; y < ways; y += WS_LANES)
                if ((unsigned)ticks[y] < t) {
                    t = (unsigned)ticks[y];
                    w = y;
                }
        }
        const unsigned least = __reduce_min_sync(ALL, t);
        return (int)__reduce_min_sync(ALL, t == least ? w : 0xffffffffu);
    }
};
#endif

// K2 for one unit: the scheduling recurrence of the timing model, with the
// searches and fetches of `lanes` (WsWarpLanes or WsHostLanes). `small` /
// `big` are the two parts of the unit's state (layout above), `st` the
// stage. L1 tags hold dense slot ids (the stream's unique blocks, remapped
// on the host), -1 for an empty way. Ops index their unit's columns from 0.
WS_HD_TEMPLATE
template <class Lanes>
WS_HD inline void ws_simulate_unit(
    Lanes &lanes, const int64_t *p, const double *f,
    const int64_t *next0, const int64_t *end,
    const int64_t *issue, const int8_t *kind,
    const int64_t *blk_off, const int64_t *blk_len,
    const int64_t *blocks, const int64_t *nbytes, const int64_t *slot,
    int64_t *small, int64_t *big, WsStage &st, double *cycles,
    int64_t *counts) {
    const int nw = (int)p[WS_N_WARPS], n_sms = (int)p[WS_N_SMS];
    const int nctrl = (int)p[WS_NCTRL], n_sets = (int)p[WS_N_SETS];
    const int ways = (int)p[WS_WAYS], ideal = (int)p[WS_IDEAL];
    const int n_slots = (int)p[WS_N_SLOTS];
    const double hit_lat = f[WS_HIT_LAT], depth = f[WS_DEPTH];
    const double dram_lat = f[WS_DRAM_LAT], svc_unit = f[WS_SVC];
    const double inf = INFINITY;
    const int lines = (int)ws_lines(p);
    const WsDiv ctrl_div = ws_div(p, WS_NCTRL, WS_CTRL_MUL, WS_CTRL_SHIFT);
    const WsDiv sets_div = ws_div(p, WS_N_SETS, WS_SETS_MUL, WS_SETS_SHIFT);

    WsWarp *warps = (WsWarp *)small;
    double *ready = (double *)(small + 4 * (int64_t)nw);
    double *issue_free = ready + nw;
    double *ctrl_free = issue_free + n_sms;
    int32_t *tick_ctr = (int32_t *)(ctrl_free + nctrl);
    double *fills = (double *)big;
    double *outst = fills + lines;
    int32_t *tags = (int32_t *)(outst + (ideal ? (int64_t)n_sms * n_slots : 0));
    int32_t *ticks = tags + lines;

    // The lanes set the state in parallel. A warp with no ops is never
    // ready; warps map to SMs as min(w * n_sms / nw, n_sms - 1).
    const int x0 = lanes.first(), dx = lanes.stride();
    for (int w = x0; w < nw; w += dx) {
        const int i = (int)next0[w], e = (int)end[w];
        const int sm = (int)((int64_t)w * n_sms / nw);
        WsWarp r = {0, i, e, sm < n_sms - 1 ? sm : n_sms - 1, 0, 0, 0};
        if (i < e) {
            r.issue = issue[i];
            r.kind = kind[i];
            r.off = (int)blk_off[i];
            r.len = (int)blk_len[i];
        }
        warps[w] = r;
        ready[w] = i < e ? 0.0 : inf;
    }
    for (int s = x0; s < n_sms; s += dx) {
        issue_free[s] = 0.0;
        tick_ctr[s] = 0;
    }
    for (int c = x0; c < nctrl; c += dx) ctrl_free[c] = 0.0;
    for (int l = x0; l < lines; l += dx) {
        tags[l] = -1;
        ticks[l] = 0;
        fills[l] = 0.0;
    }
    if (ideal)
        for (int k = x0; k < n_sms * n_slots; k += dx) outst[k] = -inf;
    lanes.sync();
    lanes.start(ready, nw);

    int64_t offchip = 0, merged = 0, l1_hits = 0;
    for (;;) {
        // Pop the first minimum of the ready times: on ties the lowest warp
        // id wins, heapq's (time, warp) order.
        double ready_t;
        const int w = lanes.pop(&ready_t);
        if (w < 0) break;
        const WsWarp r = warps[w];
        const int kind_i = r.kind, o = r.off, n_blk = r.len;
        // The lanes start fetching the op's first 32 blocks at once.
        const int gn0 = kind_i == 0 ? 0 : n_blk < WS_LANES ? n_blk : WS_LANES;
        lanes.each(gn0, [&](int x) {
            lanes.fetch(&st.block[x], blocks + o + x);
            if (kind_i == 1)
                lanes.fetch(&st.slot[x], slot + o + x);
            else
                lanes.fetch(&st.word[x].i, nbytes + o + x);
        });
        const int sm = r.sm;
        const int i = r.next;
        // Fetch the columns of the warp's following op now: they are read
        // when the warp is popped again, and the fetch overlaps this step.
        const bool more = i + 1 < r.end;
        const int j = more ? i + 1 : i;
        const int64_t issue_j = issue[j];
        const int kind_j = kind[j];
        const int off_j = (int)blk_off[j], len_j = (int)blk_len[j];
        const double free_t = issue_free[sm];
        const double t_acc = (ready_t > free_t ? ready_t : free_t)
                             + (double)r.issue;
        issue_free[sm] = t_acc;
        double warp_ready;

        if (kind_i == 0) {                        // compute
            warp_ready = t_acc + depth;
        } else if (kind_i == 1) {                 // load
            double done = t_acc + hit_lat;
            int tick = tick_ctr[sm];
            const int set0 = sm * n_sets;
            for (int g = 0; g < n_blk; g += WS_LANES) {
                const int gn = n_blk - g < WS_LANES ? n_blk - g : WS_LANES;
                if (g > 0) {                      // blocks 32 and on
                    lanes.sync();
                    lanes.each(gn, [&](int x) {
                        lanes.fetch(&st.block[x], blocks + o + g + x);
                        lanes.fetch(&st.slot[x], slot + o + g + x);
                    });
                }
                // K1: each lane preps its own block, the lanes at once.
                lanes.fetched();
                lanes.each(gn, [&](int x) {
                    const int64_t b = st.block[x];
                    st.block[x] = ws_mod(b, ctrl_div);
                    st.word[x].i = ws_mod(b, sets_div);
                });
                lanes.sync();
                for (int q = 0; q < gn; q++) {
                    const int s = (int)st.slot[q];
                    const int row = (set0 + (int)st.word[q].i) * ways;
                    const int c = (int)st.block[q];
                    // What this block reads of the SW+ table and its memory
                    // controller, loaded before the way search: no store of
                    // this iteration comes before their reads below.
                    const double out = ideal ? outst[sm * n_slots + s] : 0.0;
                    const double cf = ctrl_free[c];
                    // Every lookup is one LRU touch tick; pending lines are
                    // visible with their fill time.
                    tick++;
                    int empty;
                    bool fresh;
                    int way = lanes.find_way(tags + row, fills + row, ways, s,
                                             t_acc, &empty, &fresh);
                    if (way >= 0) {
                        ticks[row + way] = tick;
                        if (fresh) {              // fills[row + way] <= t_acc
                            l1_hits++;
                            continue;
                        }
                    }
                    // SW+: merge with an in-flight request to the same
                    // block. Read before any update of this block's entry.
                    if (ideal && out > t_acc) {
                        merged++;
                        if (out > done) done = out;
                        continue;
                    }
                    // DRAM request (a full 64 B read transaction).
                    const double start = cf > t_acc ? cf : t_acc;
                    ctrl_free[c] = start + svc_unit;
                    const double completion = start + dram_lat + svc_unit;
                    offchip++;
                    // L1 fill or pending-line allocation: a second tick.
                    tick++;
                    if (way >= 0) {
                        if (completion < fills[row + way])
                            fills[row + way] = completion;
                    } else {
                        // The first empty way, else the first valid way with
                        // the least tick (ticks are unique per SM). No tag
                        // changed since find_way looked for the empty way.
                        way = empty >= 0 ? empty
                                         : lanes.victim(ticks + row, ways);
                        tags[row + way] = s;
                        fills[row + way] = completion;
                    }
                    ticks[row + way] = tick;
                    if (ideal) outst[sm * n_slots + s] = completion;
                    if (completion > done) done = completion;
                }
            }
            tick_ctr[sm] = tick;
            warp_ready = done;
        } else {                                  // store: fire and forget
            for (int g = 0; g < n_blk; g += WS_LANES) {
                const int gn = n_blk - g < WS_LANES ? n_blk - g : WS_LANES;
                if (g > 0) {
                    lanes.sync();
                    lanes.each(gn, [&](int x) {
                        lanes.fetch(&st.block[x], blocks + o + g + x);
                        lanes.fetch(&st.word[x].i, nbytes + o + g + x);
                    });
                }
                lanes.fetched();
                lanes.each(gn, [&](int x) {
                    st.block[x] = ws_mod(st.block[x], ctrl_div);
                    st.word[x].d = ws_store_svc(svc_unit, st.word[x].i);
                });
                lanes.sync();
                for (int q = 0; q < gn; q++) {
                    const int c = (int)st.block[q];
                    const double cf = ctrl_free[c];
                    ctrl_free[c] = (cf > t_acc ? cf : t_acc) + st.word[q].d;
                }
            }
            offchip += n_blk;
            warp_ready = t_acc + hit_lat;
        }
        warps[w] = WsWarp{issue_j, i + 1, r.end, sm, kind_j, off_j, len_j};
        const double ready_w = more ? warp_ready : inf;
        ready[w] = ready_w;
        lanes.changed(ready, nw, w, ready_w);
    }

    double cyc = 0.0;
    for (int s = 0; s < n_sms; s++)
        if (issue_free[s] > cyc) cyc = issue_free[s];
    *cycles = cyc;
    counts[0] = offchip;
    counts[1] = merged;
    counts[2] = l1_hits;
}

// K2 for unit u of a family (all pointers but small / big, the two parts of
// the unit's own state, are family bases).
WS_HD_TEMPLATE
template <class Lanes>
WS_HD inline void ws_family_unit(
    Lanes &lanes, int64_t u, const int64_t *up, const double *fp,
    const int64_t *next0, const int64_t *end,
    const int64_t *issue, const int8_t *kind,
    const int64_t *blk_off, const int64_t *blk_len,
    const int64_t *blocks, const int64_t *nbytes, const int64_t *slot,
    int64_t *small, int64_t *big, WsStage &st, double *cycles,
    int64_t *counts) {
    const int64_t *p = up + u * WS_NI;
    const int64_t wo = p[WS_WARP_OFF], oo = p[WS_OP_OFF], bo = p[WS_BLK_OFF];
    ws_simulate_unit(lanes, p, fp + u * WS_NF, next0 + wo, end + wo,
                     issue + oo, kind + oo, blk_off + oo, blk_len + oo,
                     blocks + bo, nbytes + bo, slot + bo, small, big, st,
                     cycles + u, counts + 3 * u);
}
