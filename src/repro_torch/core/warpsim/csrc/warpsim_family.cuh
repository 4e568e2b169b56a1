// Trace-family timing core of the warp-size study, as code that compiles
// both for the card (nvcc, sm_90a) and for the host (g++, the CPU tests).
//
// Replaces the TPU device program src/repro/core/warpsim/_pallas.py:
//   K1  _get_launch._prep_kernel (pallas_call in _prep, _pallas.py:192-229)
//       -> ws_prep_block, launched per (unit, block) by ws_prep_kernel;
//   K2  _get_launch._simulate_one (lax.while_loop vmapped over units,
//       _pallas.py:233-407) -> ws_simulate_unit, one CUDA thread per unit
//       in ws_family_kernel.
//
// Bit-identity with the reference engines rests on doing the same IEEE-754
// double operations in the same order: build with --fmad=false (nvcc) or
// -ffp-contract=off (g++), since one contracted multiply-add changes the
// last bit of a cycle count.
//
// What bounds it on the card: K2 is latency-bound. Each unit is one
// dependent chain through simulated time (pop the earliest warp, issue one
// op, update the L1/DRAM state the next op reads), so one thread walks it
// with every step waiting on the loads of the step before. The design here
// is the simple, right one: one thread per unit, all state in global
// scratch. A later change redesigns it around a warp per unit (argmin over
// ready times and the way search across lanes, state in shared memory).
// K1 is a trivially parallel map bound by its bytes.
#pragma once

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#define WS_HD __host__ __device__
#else
#define WS_HD
#endif

// Columns of the per-unit int64 parameter table `up` [units, WS_NI]. The
// order is shared with UP_COLS in _cuda.py.
enum {
    WS_WARP_OFF = 0,  // first warp of the unit in next0 / end
    WS_OP_OFF,        // first op of the unit in issue / kind / blk_off / blk_len
    WS_BLK_OFF,       // first block of the unit in blocks / nbytes / slot / ctrl / si / ssvc
    WS_N_WARPS,
    WS_N_BLOCKS,
    WS_N_SMS,
    WS_NCTRL,         // memory controllers
    WS_N_SETS,        // L1 sets: l1_size_bytes / (transaction_bytes * l1_ways)
    WS_WAYS,
    WS_IDEAL,         // SW+ ideal coalescing (1) or not (0)
    WS_N_SLOTS,       // unique blocks of the stream: width of the outstanding table
    WS_FSCR_OFF,      // first double of the unit's f64 scratch
    WS_ISCR_OFF,      // first int64 of the unit's int64 scratch
    WS_NI
};

// Columns of the per-unit double parameter table `fp` [units, WS_NF]
// (FP_COLS in _cuda.py).
enum { WS_HIT_LAT = 0, WS_DEPTH, WS_DRAM_LAT, WS_SVC, WS_NF };

// K1 for one block: memory controller, L1 set and store occupancy. The
// occupancy has a minimum 32 B burst and divides before it multiplies,
// exactly svc * (max(nbytes, 32) / 64.0) as the reference computes it.
WS_HD inline void ws_prep_block(int64_t block, int64_t nbytes, int64_t nctrl,
                                int64_t n_sets, double svc, int64_t *ctrl,
                                int64_t *si, double *ssvc) {
    *ctrl = block % nctrl;
    *si = block % n_sets;
    *ssvc = svc * ((double)(nbytes > 32 ? nbytes : 32) / 64.0);
}

// K1 for block j of unit u of a family (all pointers are family bases).
WS_HD inline void ws_prep_unit_block(int64_t u, int64_t j, const int64_t *up,
                                     const double *fp, const int64_t *blocks,
                                     const int64_t *nbytes, int64_t *ctrl,
                                     int64_t *si, double *ssvc) {
    const int64_t *p = up + u * WS_NI;
    const int64_t b = p[WS_BLK_OFF] + j;
    ws_prep_block(blocks[b], nbytes[b], p[WS_NCTRL], p[WS_N_SETS],
                  fp[u * WS_NF + WS_SVC], &ctrl[b], &si[b], &ssvc[b]);
}

// K2 for one unit: the scheduling recurrence of the timing model.
//
// Scratch layout (the sizes fscr_len / iscr_len in _cuda.py follow it):
//   f64:   ready[n_warps] issue_free[n_sms] ctrl_free[nctrl]
//          fills[n_sms*n_sets*ways] outstanding[ideal ? n_sms*n_slots : 0]
//   int64: next[n_warps] tick_ctr[n_sms] tags[n_sms*n_sets*ways]
//          ticks[n_sms*n_sets*ways]
// L1 tags hold dense slot ids (the stream's unique blocks, remapped on the
// host), -1 for an empty way. Ops index their unit's columns from 0.
WS_HD inline void ws_simulate_unit(
    const int64_t *p, const double *f,
    const int64_t *next0, const int64_t *end,
    const int64_t *issue, const int8_t *kind,
    const int64_t *blk_off, const int64_t *blk_len,
    const int64_t *slot, const int64_t *ctrl, const int64_t *si,
    const double *ssvc, double *fscr, int64_t *iscr,
    double *cycles, int64_t *counts) {
    const int64_t nw = p[WS_N_WARPS], n_sms = p[WS_N_SMS];
    const int64_t nctrl = p[WS_NCTRL], n_sets = p[WS_N_SETS];
    const int64_t ways = p[WS_WAYS], ideal = p[WS_IDEAL];
    const int64_t n_slots = p[WS_N_SLOTS];
    const double hit_lat = f[WS_HIT_LAT], depth = f[WS_DEPTH];
    const double dram_lat = f[WS_DRAM_LAT], svc_unit = f[WS_SVC];
    const double inf = INFINITY;
    const int64_t lines = n_sms * n_sets * ways;

    double *ready = fscr;
    double *issue_free = ready + nw;
    double *ctrl_free = issue_free + n_sms;
    double *fills = ctrl_free + nctrl;
    double *outst = fills + lines;
    int64_t *next = iscr;
    int64_t *tick_ctr = next + nw;
    int64_t *tags = tick_ctr + n_sms;
    int64_t *ticks = tags + lines;

    // A warp with no ops is never ready.
    for (int64_t w = 0; w < nw; w++) {
        next[w] = next0[w];
        ready[w] = next0[w] < end[w] ? 0.0 : inf;
    }
    for (int64_t s = 0; s < n_sms; s++) {
        issue_free[s] = 0.0;
        tick_ctr[s] = 0;
    }
    for (int64_t c = 0; c < nctrl; c++) ctrl_free[c] = 0.0;
    for (int64_t l = 0; l < lines; l++) {
        tags[l] = -1;
        ticks[l] = 0;
        fills[l] = 0.0;
    }
    if (ideal)
        for (int64_t k = 0; k < n_sms * n_slots; k++) outst[k] = -inf;

    int64_t offchip = 0, merged = 0, l1_hits = 0;
    for (;;) {
        // Pop the first minimum of the ready times (strict <): on ties the
        // lowest warp id wins, heapq's (time, warp) order.
        int64_t w = -1;
        double ready_t = inf;
        for (int64_t j = 0; j < nw; j++)
            if (ready[j] < ready_t) {
                ready_t = ready[j];
                w = j;
            }
        if (w < 0) break;
        int64_t sm = w * n_sms / nw;
        if (sm > n_sms - 1) sm = n_sms - 1;
        const int64_t i = next[w];
        const double free_t = issue_free[sm];
        const double t_acc = (ready_t > free_t ? ready_t : free_t)
                             + (double)issue[i];
        issue_free[sm] = t_acc;
        const int64_t o = blk_off[i], n_blk = blk_len[i];
        double warp_ready;

        if (kind[i] == 0) {                       // compute
            warp_ready = t_acc + depth;
        } else if (kind[i] == 1) {                // load
            double done = t_acc + hit_lat;
            int64_t tick = tick_ctr[sm];
            for (int64_t b = o; b < o + n_blk; b++) {
                const int64_t s = slot[b];
                const int64_t row = (sm * n_sets + si[b]) * ways;
                // Every lookup is one LRU touch tick; pending lines are
                // visible with their fill time.
                tick++;
                int64_t way = -1;
                for (int64_t y = 0; y < ways; y++)
                    if (tags[row + y] == s) {
                        way = y;
                        break;
                    }
                if (way >= 0) {
                    ticks[row + way] = tick;
                    if (fills[row + way] <= t_acc) {
                        l1_hits++;
                        continue;
                    }
                }
                // SW+: merge with an in-flight request to the same block.
                // Read before any update of this block's entry.
                if (ideal) {
                    const double out = outst[sm * n_slots + s];
                    if (out > t_acc) {
                        merged++;
                        if (out > done) done = out;
                        continue;
                    }
                }
                // DRAM request (a full 64 B read transaction).
                const int64_t c = ctrl[b];
                const double cf = ctrl_free[c];
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
                    // The first empty way, else the first valid way with the
                    // least tick (ticks are unique per SM).
                    for (int64_t y = 0; y < ways; y++)
                        if (tags[row + y] == -1) {
                            way = y;
                            break;
                        }
                    if (way < 0) {
                        way = 0;
                        for (int64_t y = 1; y < ways; y++)
                            if (ticks[row + y] < ticks[row + way]) way = y;
                    }
                    tags[row + way] = s;
                    fills[row + way] = completion;
                }
                ticks[row + way] = tick;
                if (ideal) outst[sm * n_slots + s] = completion;
                if (completion > done) done = completion;
            }
            tick_ctr[sm] = tick;
            warp_ready = done;
        } else {                                  // store: fire and forget
            for (int64_t b = o; b < o + n_blk; b++) {
                const int64_t c = ctrl[b];
                const double cf = ctrl_free[c];
                ctrl_free[c] = (cf > t_acc ? cf : t_acc) + ssvc[b];
            }
            offchip += n_blk;
            warp_ready = t_acc + hit_lat;
        }
        next[w] = i + 1;
        ready[w] = i + 1 < end[w] ? warp_ready : inf;
    }

    double cyc = 0.0;
    for (int64_t s = 0; s < n_sms; s++)
        if (issue_free[s] > cyc) cyc = issue_free[s];
    *cycles = cyc;
    counts[0] = offchip;
    counts[1] = merged;
    counts[2] = l1_hits;
}

// K2 for unit u of a family (all pointers are family bases).
WS_HD inline void ws_family_unit(
    int64_t u, const int64_t *up, const double *fp,
    const int64_t *next0, const int64_t *end,
    const int64_t *issue, const int8_t *kind,
    const int64_t *blk_off, const int64_t *blk_len,
    const int64_t *slot, const int64_t *ctrl, const int64_t *si,
    const double *ssvc, double *fscr, int64_t *iscr,
    double *cycles, int64_t *counts) {
    const int64_t *p = up + u * WS_NI;
    const int64_t wo = p[WS_WARP_OFF], oo = p[WS_OP_OFF], bo = p[WS_BLK_OFF];
    ws_simulate_unit(p, fp + u * WS_NF, next0 + wo, end + wo, issue + oo,
                     kind + oo, blk_off + oo, blk_len + oo, slot + bo,
                     ctrl + bo, si + bo, ssvc + bo, fscr + p[WS_FSCR_OFF],
                     iscr + p[WS_ISCR_OFF], cycles + u, counts + 3 * u);
}
