// The trace-family launch on Hopper: ws_family_kernel (K2, with K1 folded
// in: one launch simulates a family) and ws_prep_kernel (K1 alone, the
// entry that checks K1's code on the card; the study does not launch it),
// with a plain C interface for ctypes. See warpsim_family.cuh for what each
// replaces and what bounds it.
//
// Build (what _cuda.py runs):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
//        -Xptxas -v -shared -Xcompiler -fPIC -o libwarpsim_family.so
//        warpsim_family.cu
//
// Each entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns the CUDA error of the launch.
#include <cuda_runtime.h>

#include "warpsim_family.cuh"

// K1 alone, off the study's path: one thread per (unit, block), grid.y the
// unit, x striding its blocks.
__global__ void ws_prep_kernel(const int64_t *up, const double *fp,
                               const int64_t *blocks, const int64_t *nbytes,
                               int64_t *ctrl, int64_t *si, double *ssvc) {
    const int64_t u = blockIdx.y;
    const int64_t n = up[u * WS_NI + WS_N_BLOCKS];
    for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < n;
         j += (int64_t)gridDim.x * blockDim.x)
        ws_prep_unit_block(u, j, up, fp, blocks, nbytes, ctrl, si, ssvc);
}

// One warp (a 32-thread block) per unit, so each unit's chain runs on an SM
// of its own; the lanes prep the blocks they stage (K1). SHARED: the unit's
// state lies in dynamic shared memory (the "shared" placement), else at its
// offsets in the global scratch ("global"). The stage lies in static shared
// memory in both.
template <bool SHARED>
__global__ void __launch_bounds__(WS_LANES)
ws_family_kernel(const int64_t *__restrict__ up, const double *__restrict__ fp,
                 const int64_t *__restrict__ next0,
                 const int64_t *__restrict__ end,
                 const int64_t *__restrict__ issue,
                 const int8_t *__restrict__ kind,
                 const int64_t *__restrict__ blk_off,
                 const int64_t *__restrict__ blk_len,
                 const int64_t *__restrict__ blocks,
                 const int64_t *__restrict__ nbytes,
                 const int64_t *__restrict__ slot, int64_t *scratch,
                 double *cycles, int64_t *counts) {
    extern __shared__ __align__(16) int64_t ws_state[];
    __shared__ WsStage stage;
    const int64_t u = blockIdx.x;
    const int64_t *p = up + u * WS_NI;
    int64_t *small = SHARED ? ws_state : scratch + p[WS_SMALL_OFF];
    int64_t *big = SHARED ? ws_state + ws_small_len(p)
                          : scratch + p[WS_BIG_OFF];
    WsWarpLanes lanes;
    ws_family_unit(lanes, u, up, fp, next0, end, issue, kind, blk_off,
                   blk_len, blocks, nbytes, slot, small, big, stage, cycles,
                   counts);
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

// smem_bytes > 0: the "shared" placement, with that much dynamic shared
// memory a block (the largest unit's state); 0: "global", with the
// scratch holding every unit's state.
extern "C" int ws_family_launch(const void *up, const void *fp,
                                const void *next0, const void *end,
                                const void *issue, const void *kind,
                                const void *blk_off, const void *blk_len,
                                const void *blocks, const void *nbytes,
                                const void *slot, void *scratch,
                                void *cycles, void *counts,
                                int64_t n_units, int64_t smem_bytes,
                                void *stream) {
    auto kernel = smem_bytes > 0 ? ws_family_kernel<true>
                                 : ws_family_kernel<false>;
    if (smem_bytes > 0) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem_bytes);
        if (err != cudaSuccess) return (int)err;
    }
    kernel<<<(unsigned)n_units, WS_LANES, (size_t)smem_bytes,
             (cudaStream_t)stream>>>(
        (const int64_t *)up, (const double *)fp, (const int64_t *)next0,
        (const int64_t *)end, (const int64_t *)issue, (const int8_t *)kind,
        (const int64_t *)blk_off, (const int64_t *)blk_len,
        (const int64_t *)blocks, (const int64_t *)nbytes,
        (const int64_t *)slot, (int64_t *)scratch, (double *)cycles,
        (int64_t *)counts);
    return (int)cudaGetLastError();
}

extern "C" const char *ws_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
