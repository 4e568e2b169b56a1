// K5 on Hopper: online-softmax attention over (BH, S, hd),
// out = softmax(q k^T / sqrt(hd), causal mask) v, float32 inside, the
// result cast to q's dtype with round-to-nearest.
//
// Replaces src/repro/kernels/flash_attention.py::_flash_kernel (the Pallas
// kernel behind flash_attention). There, a (BH, Sq/BQ, Sk/BKV) grid walks
// the KV axis innermost ("arbitrary"), carrying the running max m, the sum
// l and the (BQ, hd) accumulator in VMEM scratch from one grid step to the
// next, and skips KV blocks above the diagonal (ki*bkv <= qi*bq + bq-1).
//
// Bound on this card: operations. The causal half of 4*BH*S^2*hd FLOPs
// against a few bytes per element of q, k, v and out: at the kernel-bench
// shape (BH 8, S 2048, hd 64, float32) 4.29 GFLOP against 16.8 MB, about
// 0.064 ms at the 67 TFLOP/s of float32 outside the tensor cores (float32
// inputs at a 2e-5 tolerance cannot use TF32). This first version stays on
// the CUDA cores in float32 for both dtypes; mma.sync/wgmma on bf16 tiles
// and TMA are later work.
//
// Design. Blocks run in parallel in no order, so the sequential KV grid
// axis becomes a loop inside the block: one block owns one (bh, tile of
// QT = 64 query rows) and walks the keys KT = 32 at a time, stopping at
// the causal bound (keys < q0 + QT). m, l and the accumulator live in
// registers. Eight warps own eight query rows each. hd (a multiple of 8, at
// most 128) is split across a warp's lanes for the accumulator (lane owns
// d = lane + 32 j); for the scores each lane owns one key of the tile and
// takes the whole dot product from shared memory (K rows padded to hd + 1
// floats, so the 32 lanes hit 32 banks), which gives the tile's 32 scores
// of a row with no shuffle; the row max and sum over the tile take five
// shuffles each. Probabilities go through a small shared buffer to the
// accumulate step. Shared memory is dynamic: Q tile 64 x hd, K 32 x (hd+1),
// V 32 x hd and P 8 x 8 x 32 floats, 73,856 bytes at hd 128, above the 48 KB
// of static shared memory.
// The reference's bq/bkv (tile sizes) do not reach this kernel: its tiling
// is fixed (QT, KT), and a softmax over float32 sums in another order stays
// within the reference's tile-invariance tolerance (2e-5). The wrapper
// still checks them as the reference asserts them. A masked score is
// -2e38 in the max (never -inf: inf - inf is NaN) and contributes p = 0,
// as exp(-2e38 - m) does in the reference once a row has seen key 0, which
// every tile walk starts with; l is clamped at 1e-30. Keys past Sk and
// query rows past Sq are masked, not padded.
//
// Build (what kernels/_lib.py runs):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xptxas -v
//        -shared -Xcompiler -fPIC -o libflash_attention.so flash_attention.cu
//
// The entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() of the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int QT = 64;                   // query rows per block
constexpr int KT = 32;                   // keys per tile: one per lane
constexpr int WARPS = 8;
constexpr int ROWS = QT / WARPS;         // query rows per warp
constexpr int THREADS = 32 * WARPS;      // 256
constexpr float NEG = -2.0e38f;

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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

size_t smem_bytes(int hd) {
    return sizeof(float) * ((size_t)QT * hd + (size_t)KT * (hd + 1) +
                            (size_t)KT * hd + (size_t)WARPS * ROWS * KT);
}

}  // namespace

// q: (bh, sq, hd); k, v: (bh, sk, hd); out: (bh, sq, hd). NJ = ceil(hd/32).
template <typename T, int NJ>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T *__restrict__ q, const T *__restrict__ k,
                       const T *__restrict__ v, T *__restrict__ out,
                       int sq, int sk, int hd, float scale, int causal) {
    extern __shared__ float smem[];
    float *qs = smem;                          // [QT][hd], scaled
    float *ks = qs + QT * hd;                  // [KT][hd + 1]
    float *vs = ks + KT * (hd + 1);            // [KT][hd]
    float *ps = vs + KT * hd;                  // [WARPS][ROWS][KT]

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    // Longest causal walks first: the last query tile starts first.
    const int q0 = (gridDim.x - 1 - blockIdx.x) * QT;
    const int64_t base_q = (int64_t)blockIdx.y * sq * hd;
    const int64_t base_k = (int64_t)blockIdx.y * sk * hd;

    for (int e = tid; e < QT * hd; e += THREADS) {
        const int r = e / hd, d = e % hd;
        qs[e] = q0 + r < sq ? to_f32(q[base_q + (int64_t)(q0 + r) * hd + d])
                                  * scale
                            : 0.0f;
    }

    const int row0 = q0 + warp * ROWS;         // this warp's first row
    float m[ROWS], l[ROWS], acc[ROWS][NJ];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
        m[r] = NEG;
        l[r] = 0.0f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[r][j] = 0.0f;
    }

    const int k_end = causal ? min(sk, q0 + QT) : sk;
    for (int k0 = 0; k0 < k_end; k0 += KT) {
        __syncthreads();                       // previous tile consumed
        for (int e = tid; e < KT * hd; e += THREADS) {
            const int r = e / hd, d = e % hd;
            const bool in = k0 + r < sk;
            const int64_t g = base_k + (int64_t)(k0 + r) * hd + d;
            ks[r * (hd + 1) + d] = in ? to_f32(k[g]) : 0.0f;
            vs[e] = in ? to_f32(v[g]) : 0.0f;
        }
        __syncthreads();
        // A warp whose rows all lie above this tile's first key (causal)
        // or past Sq has nothing to add.
        if (row0 >= sq || (causal && k0 > row0 + ROWS - 1)) continue;

        const int key = k0 + lane;
        float s[ROWS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) s[r] = 0.0f;
        const float *krow = ks + lane * (hd + 1);
        for (int d = 0; d < hd; ++d) {
            const float kd = krow[d];
#pragma unroll
            for (int r = 0; r < ROWS; ++r)
                s[r] += qs[(warp * ROWS + r) * hd + d] * kd;
        }
        float *pw = ps + warp * ROWS * KT;
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
            const int qrow = row0 + r;
            const bool valid = key < sk && (!causal || key <= qrow);
            const float sm = valid ? s[r] : NEG;
            const float m_new = fmaxf(m[r], warp_max(sm));
            const float p = valid ? expf(sm - m_new) : 0.0f;
            const float corr = expf(m[r] - m_new);
            l[r] = l[r] * corr + warp_sum(p);
            m[r] = m_new;
#pragma unroll
            for (int j = 0; j < NJ; ++j) acc[r][j] *= corr;
            pw[r * KT + lane] = p;
        }
        __syncwarp();
        for (int kk = 0; kk < KT; ++kk) {
            float vd[NJ];
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                const int d = lane + 32 * j;
                vd[j] = d < hd ? vs[kk * hd + d] : 0.0f;
            }
#pragma unroll
            for (int r = 0; r < ROWS; ++r) {
                const float p = pw[r * KT + kk];
#pragma unroll
                for (int j = 0; j < NJ; ++j) acc[r][j] += p * vd[j];
            }
        }
        __syncwarp();                          // pw read before rewritten
    }

#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
        const int qrow = row0 + r;
        if (qrow >= sq) continue;
        const float inv = 1.0f / fmaxf(l[r], 1e-30f);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            const int d = lane + 32 * j;
            if (d < hd)
                out[base_q + (int64_t)qrow * hd + d] =
                    from_f32<T>(acc[r][j] * inv);
        }
    }
}

namespace {

template <typename T, int NJ>
int launch(const void *q, const void *k, const void *v, void *out, int bh,
           int sq, int sk, int hd, float scale, int causal,
           cudaStream_t s) {
    const size_t smem = smem_bytes(hd);
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, NJ>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((unsigned)((sq + QT - 1) / QT), (unsigned)bh);
    flash_attention_kernel<T, NJ><<<grid, THREADS, smem, s>>>(
        (const T *)q, (const T *)k, (const T *)v, (T *)out, sq, sk, hd,
        scale, causal);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_dtype(const void *q, const void *k, const void *v, void *out,
                 int bh, int sq, int sk, int hd, float scale, int causal,
                 cudaStream_t s) {
    switch ((hd + 31) / 32) {
    case 1: return launch<T, 1>(q, k, v, out, bh, sq, sk, hd, scale, causal, s);
    case 2: return launch<T, 2>(q, k, v, out, bh, sq, sk, hd, scale, causal, s);
    case 3: return launch<T, 3>(q, k, v, out, bh, sq, sk, hd, scale, causal, s);
    case 4: return launch<T, 4>(q, k, v, out, bh, sq, sk, hd, scale, causal, s);
    default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v and out share it). hd % 8 == 0,
// 8 <= hd <= 128, 1 <= bh <= 65535, sq, sk >= 1 (checked by the wrapper).
extern "C" int flash_attention_launch(const void *q, const void *k,
                                      const void *v, void *out, int bh,
                                      int sq, int sk, int hd, float scale,
                                      int causal, int dtype, void *stream) {
    if (bh <= 0 || bh > 65535 || sq <= 0 || sk <= 0 || hd <= 0 ||
        hd > 128 || hd % 8 != 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0)
        return launch_dtype<float>(q, k, v, out, bh, sq, sk, hd, scale,
                                   causal, s);
    if (dtype == 1)
        return launch_dtype<__nv_bfloat16>(q, k, v, out, bh, sq, sk, hd,
                                           scale, causal, s);
    return (int)cudaErrorInvalidValue;
}

extern "C" const char *kernel_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
