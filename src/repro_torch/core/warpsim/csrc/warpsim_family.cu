// The trace-family launch on Hopper: K1 (ws_prep_kernel) and K2
// (ws_family_kernel), with a plain C interface for ctypes. See
// warpsim_family.cuh for what each replaces and what bounds it.
//
// Build (what _cuda.py runs):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -shared -Xcompiler -fPIC -o libwarpsim_family.so warpsim_family.cu
//
// Each entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() of the launch.
#include <cuda_runtime.h>

#include "warpsim_family.cuh"

// One thread per (unit, block): grid.y is the unit, x strides its blocks.
__global__ void ws_prep_kernel(const int64_t *up, const double *fp,
                               const int64_t *blocks, const int64_t *nbytes,
                               int64_t *ctrl, int64_t *si, double *ssvc) {
    const int64_t u = blockIdx.y;
    const int64_t n = up[u * WS_NI + WS_N_BLOCKS];
    for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < n;
         j += (int64_t)gridDim.x * blockDim.x)
        ws_prep_unit_block(u, j, up, fp, blocks, nbytes, ctrl, si, ssvc);
}

// One single-thread block per unit, so each unit's chain runs on its own
// SM instead of serialising with other units in one warp's lanes.
__global__ void ws_family_kernel(const int64_t *up, const double *fp,
                                 const int64_t *next0, const int64_t *end,
                                 const int64_t *issue, const int8_t *kind,
                                 const int64_t *blk_off,
                                 const int64_t *blk_len, const int64_t *slot,
                                 const int64_t *ctrl, const int64_t *si,
                                 const double *ssvc, double *fscr,
                                 int64_t *iscr, double *cycles,
                                 int64_t *counts) {
    ws_family_unit(blockIdx.x, up, fp, next0, end, issue, kind, blk_off,
                   blk_len, slot, ctrl, si, ssvc, fscr, iscr, cycles, counts);
}

extern "C" int ws_prep_launch(const void *up, const void *fp,
                              const void *blocks, const void *nbytes,
                              void *ctrl, void *si, void *ssvc,
                              int64_t n_units, int64_t max_blocks,
                              void *stream) {
    const int threads = 256;
    int64_t gx = (max_blocks + threads - 1) / threads;
    if (gx < 1) gx = 1;
    if (gx > 1024) gx = 1024;
    dim3 grid((unsigned)gx, (unsigned)n_units);
    ws_prep_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const int64_t *)up, (const double *)fp, (const int64_t *)blocks,
        (const int64_t *)nbytes, (int64_t *)ctrl, (int64_t *)si,
        (double *)ssvc);
    return (int)cudaGetLastError();
}

extern "C" int ws_family_launch(const void *up, const void *fp,
                                const void *next0, const void *end,
                                const void *issue, const void *kind,
                                const void *blk_off, const void *blk_len,
                                const void *slot, const void *ctrl,
                                const void *si, const void *ssvc, void *fscr,
                                void *iscr, void *cycles, void *counts,
                                int64_t n_units, void *stream) {
    ws_family_kernel<<<(unsigned)n_units, 1, 0, (cudaStream_t)stream>>>(
        (const int64_t *)up, (const double *)fp, (const int64_t *)next0,
        (const int64_t *)end, (const int64_t *)issue, (const int8_t *)kind,
        (const int64_t *)blk_off, (const int64_t *)blk_len,
        (const int64_t *)slot, (const int64_t *)ctrl, (const int64_t *)si,
        (const double *)ssvc, (double *)fscr, (int64_t *)iscr,
        (double *)cycles, (int64_t *)counts);
    return (int)cudaGetLastError();
}

extern "C" const char *ws_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
