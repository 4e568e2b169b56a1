// Host-only build of the family kernels' device code, for the CPU tests:
// the same ws_prep_unit_block / ws_family_unit that warpsim_family.cu
// launches, looped over units on the host. Not on the port's run path.
//
//   g++ -O2 -ffp-contract=off -std=c++17 -shared -fPIC
//       -o libwarpsim_host.so warpsim_host.cpp
#include "warpsim_family.cuh"

extern "C" int ws_host_family(const int64_t *up, const double *fp,
                              const int64_t *next0, const int64_t *end,
                              const int64_t *issue, const int8_t *kind,
                              const int64_t *blk_off, const int64_t *blk_len,
                              const int64_t *blocks, const int64_t *nbytes,
                              const int64_t *slot, int64_t *ctrl, int64_t *si,
                              double *ssvc, double *fscr, int64_t *iscr,
                              double *cycles, int64_t *counts,
                              int64_t n_units) {
    for (int64_t u = 0; u < n_units; u++)
        for (int64_t j = 0; j < up[u * WS_NI + WS_N_BLOCKS]; j++)
            ws_prep_unit_block(u, j, up, fp, blocks, nbytes, ctrl, si, ssvc);
    for (int64_t u = 0; u < n_units; u++)
        ws_family_unit(u, up, fp, next0, end, issue, kind, blk_off, blk_len,
                       slot, ctrl, si, ssvc, fscr, iscr, cycles, counts);
    return 0;
}
