// Host-only build of the family kernels' device code, for the CPU tests:
// the same ws_family_unit (with K1 folded in) and ws_prep_unit_block that
// warpsim_family.cu launches, with the host form of the searches
// (WsHostLanes), looped over units on the host. Not on the port's run path.
//
//   g++ -O2 -ffp-contract=off -std=c++17 -shared -fPIC
//       -o libwarpsim_host.so warpsim_host.cpp
#include "warpsim_family.cuh"

// shared == nullptr: the "global" placement, every unit's state at its
// offsets in `scratch`. Else "shared": each unit in turn carves its state
// from `shared` (as large as the largest unit's state), as a block carves
// its dynamic shared memory.
extern "C" int ws_host_family(const int64_t *up, const double *fp,
                              const int64_t *next0, const int64_t *end,
                              const int64_t *issue, const int8_t *kind,
                              const int64_t *blk_off, const int64_t *blk_len,
                              const int64_t *blocks, const int64_t *nbytes,
                              const int64_t *slot, int64_t *scratch,
                              int64_t *shared, double *cycles, int64_t *counts,
                              int64_t n_units) {
    for (int64_t u = 0; u < n_units; u++) {
        const int64_t *p = up + u * WS_NI;
        int64_t *small = shared ? shared : scratch + p[WS_SMALL_OFF];
        int64_t *big = shared ? shared + ws_small_len(p)
                              : scratch + p[WS_BIG_OFF];
        WsHostLanes lanes;
        WsStage stage;
        ws_family_unit(lanes, u, up, fp, next0, end, issue, kind, blk_off,
                       blk_len, blocks, nbytes, slot, small, big, stage,
                       cycles, counts);
    }
    return 0;
}

// K1 alone, as ws_prep_kernel runs it: every block of every unit.
extern "C" int ws_host_prep(const int64_t *up, const double *fp,
                            const int64_t *blocks, const int64_t *nbytes,
                            int64_t *ctrl, int64_t *si, double *ssvc,
                            int64_t n_units) {
    for (int64_t u = 0; u < n_units; u++)
        for (int64_t j = 0; j < up[u * WS_NI + WS_N_BLOCKS]; j++)
            ws_prep_unit_block(u, j, up, fp, blocks, nbytes, ctrl, si, ssvc);
    return 0;
}

// ws_mod over n dividends b, for the CPU tests: r[k] = b[k] % d given d's
// multiply-high constants m and l.
extern "C" void ws_host_mod(const int64_t *b, int64_t n, int64_t d,
                            uint64_t m, int64_t l, int64_t *r) {
    const WsDiv v{d, m, (int)l};
    for (int64_t k = 0; k < n; k++) r[k] = ws_mod(b[k], v);
}

// The searches alone, for the CPU tests' crafted ties. ws_host_pops pops n
// times from ready (nw warps), giving the k-th popped warp the ready time
// after[k]; it writes each popped warp (-1 once every warp is inf) to
// order and returns the number of pops made.
extern "C" int64_t ws_host_pops(double *ready, int nw, const double *after,
                                int64_t n, int64_t *order) {
    WsHostLanes lanes;
    lanes.start(ready, nw);
    for (int64_t k = 0; k < n; k++) {
        double t;
        const int w = lanes.pop(&t);
        order[k] = w;
        if (w < 0) return k + 1;
        ready[w] = after[k];
        lanes.changed(ready, nw, w, after[k]);
    }
    return n;
}

extern "C" int ws_host_find_way(const int32_t *tags, const double *fills,
                                int ways, int s, double t, int *empty,
                                bool *fresh) {
    return WsHostLanes::find_way(tags, fills, ways, s, t, empty, fresh);
}

extern "C" int ws_host_victim(const int32_t *ticks, int ways) {
    return WsHostLanes::victim(ticks, ways);
}
