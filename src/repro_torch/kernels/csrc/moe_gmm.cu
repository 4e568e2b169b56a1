// K4 on Hopper: the grouped matmul of SW+ MoE dispatch,
// out[i] = x[i] @ w[block_expert[i / bm]], float32 accumulation, the
// result cast to x's dtype.
//
// Replaces src/repro/kernels/moe_gmm.py::_gmm_kernel (the Pallas kernel
// behind gmm). There, an (M/BM, N/BN, K/BK) grid walks K innermost,
// carrying a float32 (BM, BN) accumulator in VMEM from one grid step to
// the next, and block_expert is scalar-prefetched so each step's weight
// BlockSpec DMAs the right expert's (BK, BN) tile; K and N are
// zero-padded to tile multiples.
//
// Bound on this card: operations. At the serve path's shapes (M = 8192
// rows, K x N = 2048 x 1408 or 1408 x 2048, bf16) one launch is 47.2
// GFLOP, about 0.048 ms at the tensor cores' 989 TFLOP/s, against about
// 0.046 ms for its bytes. This first version does not reach the tensor
// cores: it is a plain tiled product on the CUDA cores (67 TFLOP/s of
// float32 at best), right first; mma.sync, wgmma and TMA are later work.
// Design: one CUDA block per 64 x 64 output tile; blocks run in parallel,
// so the sequential K grid dimension of the TPU kernel becomes a loop over
// K inside the block, through shared memory, 32 at a time, with the sums
// in registers (4 x 4 per thread). Each block reads its expert from
// block_expert itself (no scalar prefetch); a 64-row tile never straddles
// two bm-row blocks because the wrapper requires bm % 64 == 0. The ragged
// N and K edges are masked in the loads and the store instead of padded
// copies (the zeros of the reference's padding add nothing). Inputs are
// converted to float32 as they enter shared memory.
//
// Build (what kernels/_lib.py runs):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xptxas -v
//        -shared -Xcompiler -fPIC -o libmoe_gmm.so moe_gmm.cu
//
// The entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() of the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;   // output rows per block
constexpr int BN = 64;   // output columns per block
constexpr int BK = 32;   // K per shared-memory stage
constexpr int TM = 4;    // rows per thread
constexpr int TN = 4;    // columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);   // 256

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
    return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
    return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
    return __float2bfloat16_rn(v);
}

}  // namespace

// x: (m, k); w: (n_experts, k, n); block_expert: (m / bm,); out: (m, n).
// m % bm == 0 and bm % BM == 0 (checked by the wrapper).
template <typename T>
__global__ void __launch_bounds__(THREADS)
gmm_kernel(const T *__restrict__ x, const T *__restrict__ w,
           const int32_t *__restrict__ block_expert, T *__restrict__ out,
           int64_t k, int64_t n, int64_t n_experts, int64_t bm) {
    __shared__ float xs[BK][BM + 4];   // x tile, K-major: xs[kk][row]
    __shared__ float ws[BK][BN + 4];   // weight tile: ws[kk][col]

    const int64_t row0 = (int64_t)blockIdx.y * BM;
    const int64_t col0 = (int64_t)blockIdx.x * BN;
    int64_t e = block_expert[row0 / bm];
    e = e < 0 ? 0 : (e >= n_experts ? n_experts - 1 : e);
    const T *we = w + e * k * n;
    const T *xb = x + row0 * k;

    const int tid = threadIdx.x;
    const int tx = tid % (BN / TN);
    const int ty = tid / (BN / TN);
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

    for (int64_t k0 = 0; k0 < k; k0 += BK) {
        // x tile: BM rows x BK columns; neighbouring threads read
        // neighbouring k of one row.
#pragma unroll
        for (int q = tid; q < BM * BK; q += THREADS) {
            const int r = q / BK, c = q % BK;
            const int64_t gk = k0 + c;
            xs[c][r] = gk < k ? to_f32(xb[(int64_t)r * k + gk]) : 0.0f;
        }
        // weight tile: BK rows x BN columns; neighbouring threads read
        // neighbouring n of one row.
#pragma unroll
        for (int q = tid; q < BK * BN; q += THREADS) {
            const int r = q / BN, c = q % BN;
            const int64_t gk = k0 + r, gn = col0 + c;
            ws[r][c] = (gk < k && gn < n) ? to_f32(we[gk * n + gn]) : 0.0f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
            float a[TM], b[TN];
#pragma unroll
            for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty * TM + i];
#pragma unroll
            for (int j = 0; j < TN; ++j) b[j] = ws[kk][tx * TN + j];
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j) acc[i][j] += a[i] * b[j];
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const int64_t r = row0 + ty * TM + i;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int64_t c = col0 + tx * TN + j;
            if (c < n) out[r * n + c] = from_f32<T>(acc[i][j]);
        }
    }
}

// dtype: 0 float32, 1 bfloat16 (x, w and out share it).
extern "C" int gmm_launch(const void *x, const void *w,
                          const void *block_expert, void *out, int64_t m,
                          int64_t k, int64_t n, int64_t n_experts,
                          int64_t bm, int dtype, void *stream) {
    if (m % BM != 0 || bm % BM != 0 || m / BM > 65535 || m <= 0 || n <= 0)
        return (int)cudaErrorInvalidValue;
    dim3 grid((unsigned)((n + BN - 1) / BN), (unsigned)(m / BM));
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0) {
        gmm_kernel<float><<<grid, THREADS, 0, s>>>(
            (const float *)x, (const float *)w, (const int32_t *)block_expert,
            (float *)out, k, n, n_experts, bm);
    } else if (dtype == 1) {
        gmm_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
            (const __nv_bfloat16 *)x, (const __nv_bfloat16 *)w,
            (const int32_t *)block_expert, (__nv_bfloat16 *)out, k, n,
            n_experts, bm);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

extern "C" const char *kernel_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
