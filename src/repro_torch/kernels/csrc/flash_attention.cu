// K5 on Hopper: online-softmax attention over (BH, S, hd),
// out = softmax(q k^T / sqrt(hd), causal mask) v, float32 statistics and
// sums, the result cast to q's dtype with round-to-nearest.
//
// Replaces src/repro/kernels/flash_attention.py::_flash_kernel (the Pallas
// kernel behind flash_attention). There, a (BH, Sq/BQ, Sk/BKV) grid walks
// the KV axis innermost ("arbitrary"), carrying the running max m, the sum
// l and the (BQ, hd) accumulator in VMEM scratch from one grid step to the
// next, and skips KV blocks above the diagonal (ki*bkv <= qi*bq + bq-1).
//
// Bound on this card: operations. The causal half of 4*BH*S^2*hd FLOPs
// against a few bytes per element of q, k, v and out: at (16, 2048, 128)
// bf16, 17.2 GFLOP, 0.017 ms at the tensor cores' 989 TFLOP/s; at the
// kernel-bench shape (8, 2048, 64) float32, 4.29 GFLOP, 0.064 ms at the 67
// TFLOP/s of float32 outside the tensor cores (float32 inputs at a 2e-5
// tolerance cannot use TF32).
//
// Blocks run in parallel in no order, so the sequential KV grid axis
// becomes a loop inside the block: one block owns one (bh, tile of FQ = 64
// query rows) and walks the keys FK = 64 at a time, stopping at the causal
// bound (keys < q0 + FQ); the longest walks (the last query tiles) are
// launched first. m, l and the accumulator live in registers. K and V
// tiles are double-buffered in shared memory by cp.async: tile t + 1 is in
// flight while tile t is used. Keys past Sk and query rows past Sq are
// zero-filled by the copies and masked, not padded in device memory. Two
// routes, by dtype:
//
// * bf16, on the tensor cores (flash_attention_kernel_tc), in
//   FlashAttention-2's layout. 4 warps each own 16 query rows, their Q
//   fragments held in registers from ldmatrix. S = Q K^T by
//   mma.sync.m16n8k16 (bf16 in, float32 accumulators), K read with
//   ldmatrix and V with ldmatrix.trans;
//   shared-memory rows are padded by 16 bytes, so the eight rows of each
//   8 x 8 ldmatrix hit eight different bank groups. The scale, the mask
//   and the online-softmax update run on the accumulators in registers
//   (row max over the quad of lanes sharing a row by two shuffles; the row
//   sum stays per lane until the end). P is rounded to bf16 in registers
//   and used directly as the A operand of P V: no shared round trip. hd
//   (a multiple of 8, at most 128) is padded with zeros to HDP = 32, 64 or
//   128 in shared memory, which changes no sum.
// * float32, on the CUDA cores (flash_attention_kernel_f32). 256 threads,
//   each owning a 4 x 4 block of the 64 x 64 score tile (rows ty + 16 i, keys
//   tx + 16 j, so the float4 loads of K rows from shared memory hit eight
//   different bank groups), 16 FMAs per pair of float4 loads; row max and
//   sum by shuffles across the 16 threads that share a row; P goes through
//   shared memory to P V, which is register-tiled the same way over hd (a
//   thread owns 4 rows x 4 consecutive columns of each 64-column chunk).
//
// A masked score is -2e38 in the max (never -inf: inf - inf is NaN) and
// contributes p = exp(-2e38 - m) = 0 once a row has seen key 0, which
// every tile walk starts with; l is clamped at 1e-30. The reference's
// bq/bkv do not reach either kernel (their tiling is fixed); the wrapper
// checks them as the reference asserts them.
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

constexpr int FQ = 64;                   // query rows per block
constexpr int FK = 64;                   // keys per tile
constexpr float NEG = -2.0e38f;
constexpr float LOG2E = 1.4426950408889634f;

constexpr int TC_THREADS = 128;          // bf16 route: 4 warps x 16 rows
constexpr int F32_THREADS = 256;         // float32 route: 16 x 16 threads
constexpr int PLD = FK + 16;             // float32 P rows: two rows of a
                                         // warp fall in disjoint banks

__device__ __forceinline__ uint32_t smem_u32(const void *p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes when !ok.
__device__ __forceinline__ void cp_async16(void *dst, const void *src,
                                           bool ok) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N> __device__ __forceinline__ void cp_wait() {
    asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// `rows` rows of `width` elements (a multiple of 16 bytes) from the rows
// first_row.. of src (row stride hd) into dst (row stride ld); rows at or
// past n_src and columns at or past hd become zeros.
template <typename T>
__device__ __forceinline__ void load_tile(T *dst, int ld, const T *src,
                                          int first_row, int n_src, int hd,
                                          int width, int rows, int tid,
                                          int nthreads) {
    constexpr int E = 16 / sizeof(T);
    const int cpr = width / E;
    for (int c = tid; c < rows * cpr; c += nthreads) {
        const int r = c / cpr, ch = c % cpr;
        const bool ok = first_row + r < n_src && ch * E < hd;
        const T *g = ok ? src + (int64_t)(first_row + r) * hd + ch * E : src;
        cp_async16(dst + r * ld + ch * E, g, ok);
    }
}

__device__ __forceinline__ void ldsm_x4(uint32_t *r, const void *p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 "
                 "{%0, %1, %2, %3}, [%4];"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t *r, const void *p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
                 "{%0, %1, %2, %3}, [%4];"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p)));
}

// c (16 x 8, float32) += a (16 x 16, bf16, row) . b (16 x 8, bf16, col).
__device__ __forceinline__ void mma_bf16(float *c, const uint32_t *a,
                                         uint32_t b0, uint32_t b1) {
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                 "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
                 "{%0, %1, %2, %3};"
                 : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
                   "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);   // .x is the low half
    return *reinterpret_cast<uint32_t *>(&h);
}

__device__ __forceinline__ float quad_max(float v) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float half_max(float v) {   // 16 lanes
#pragma unroll
    for (int o = 1; o < 16; o <<= 1)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

}  // namespace

// ---- bf16 on the tensor cores --------------------------------------------
// q: (bh, sq, hd); k, v: (bh, sk, hd); out: (bh, sq, hd); hd <= HDP.
template <int HDP>
__global__ void __launch_bounds__(TC_THREADS)
flash_attention_kernel_tc(const __nv_bfloat16 *__restrict__ q,
                          const __nv_bfloat16 *__restrict__ k,
                          const __nv_bfloat16 *__restrict__ v,
                          __nv_bfloat16 *__restrict__ out, int sq, int sk,
                          int hd, float scale_log2, int causal) {
    constexpr int LD = HDP + 8;          // padded row: 16 bytes more
    constexpr int KC = HDP / 16;         // 16-wide chunks of hd
    extern __shared__ uint4 smem4[];
    __nv_bfloat16 *qs = reinterpret_cast<__nv_bfloat16 *>(smem4);
    __nv_bfloat16 *ks = qs + FQ * LD;    // [2][FK][LD]
    __nv_bfloat16 *vs = ks + 2 * FK * LD;

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int q0 = (gridDim.x - 1 - blockIdx.x) * FQ;
    const __nv_bfloat16 *qb = q + (int64_t)blockIdx.y * sq * hd;
    const __nv_bfloat16 *kb = k + (int64_t)blockIdx.y * sk * hd;
    const __nv_bfloat16 *vb = v + (int64_t)blockIdx.y * sk * hd;
    const int k_end = causal ? min(sk, q0 + FQ) : sk;
    const int ntiles = (k_end + FK - 1) / FK;

    load_tile(qs, LD, qb, q0, sq, hd, HDP, FQ, tid, TC_THREADS);
    load_tile(ks, LD, kb, 0, sk, hd, HDP, FK, tid, TC_THREADS);
    load_tile(vs, LD, vb, 0, sk, hd, HDP, FK, tid, TC_THREADS);
    cp_commit();

    // Fragment coordinates: a lane holds rows g and g + 8 of its warp's 16
    // and columns 2 t, 2 t + 1 of each 8-wide n-tile; ldmatrix takes the
    // address of row r8 of 8 x 8 matrix mi from each lane.
    const int g = lane >> 2, t = lane & 3, mi = lane >> 3, r8 = lane & 7;
    const int row_a = q0 + warp * 16 + g, row_b = row_a + 8;
    uint32_t qf[KC][4];
    float o[2 * KC][4];
#pragma unroll
    for (int j = 0; j < 2 * KC; ++j)
        o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
    float m_a = NEG, m_b = NEG, l_a = 0.0f, l_b = 0.0f;

    for (int it = 0; it < ntiles; ++it) {
        const int buf = it & 1;
        if (it + 1 < ntiles) {           // next tile in flight
            const int nb = buf ^ 1;
            load_tile(ks + nb * FK * LD, LD, kb, (it + 1) * FK, sk, hd, HDP,
                      FK, tid, TC_THREADS);
            load_tile(vs + nb * FK * LD, LD, vb, (it + 1) * FK, sk, hd, HDP,
                      FK, tid, TC_THREADS);
            cp_commit();
            cp_wait<1>();
        } else {
            cp_wait<0>();
        }
        __syncthreads();
        if (it == 0) {
#pragma unroll
            for (int kc = 0; kc < KC; ++kc)
                ldsm_x4(qf[kc], qs + (warp * 16 + (lane & 15)) * LD +
                                    16 * kc + (lane >> 4) * 8);
        }
        const __nv_bfloat16 *kt = ks + buf * FK * LD;
        const __nv_bfloat16 *vt = vs + buf * FK * LD;

        // S = Q K^T: 8 n-tiles of 8 keys.
        float s[FK / 8][4];
#pragma unroll
        for (int j = 0; j < FK / 8; ++j)
            s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
        for (int p = 0; p < FK / 16; ++p) {
#pragma unroll
            for (int kc = 0; kc < KC; ++kc) {
                uint32_t b[4];
                ldsm_x4(b, kt + (16 * p + (mi >> 1) * 8 + r8) * LD + 16 * kc +
                               (mi & 1) * 8);
                mma_bf16(s[2 * p], qf[kc], b[0], b[1]);
                mma_bf16(s[2 * p + 1], qf[kc], b[2], b[3]);
            }
        }

        // Scale (log2 domain), mask, online softmax on the accumulators.
        const int k0 = it * FK;
        float mx_a = m_a, mx_b = m_b;
#pragma unroll
        for (int j = 0; j < FK / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int key = k0 + 8 * j + 2 * t + e;
                const bool in = key < sk;
                s[j][e] = in && (!causal || key <= row_a)
                              ? s[j][e] * scale_log2 : NEG;
                s[j][2 + e] = in && (!causal || key <= row_b)
                                  ? s[j][2 + e] * scale_log2 : NEG;
                mx_a = fmaxf(mx_a, s[j][e]);
                mx_b = fmaxf(mx_b, s[j][2 + e]);
            }
        }
        mx_a = quad_max(mx_a);
        mx_b = quad_max(mx_b);
        const float c_a = exp2f(m_a - mx_a), c_b = exp2f(m_b - mx_b);
        m_a = mx_a;
        m_b = mx_b;
        l_a *= c_a;
        l_b *= c_b;
#pragma unroll
        for (int j = 0; j < FK / 8; ++j) {
            s[j][0] = exp2f(s[j][0] - m_a);
            s[j][1] = exp2f(s[j][1] - m_a);
            s[j][2] = exp2f(s[j][2] - m_b);
            s[j][3] = exp2f(s[j][3] - m_b);
            l_a += s[j][0] + s[j][1];
            l_b += s[j][2] + s[j][3];
        }
#pragma unroll
        for (int j = 0; j < 2 * KC; ++j) {
            o[j][0] *= c_a;
            o[j][1] *= c_a;
            o[j][2] *= c_b;
            o[j][3] *= c_b;
        }

        // O += P V: P from the S accumulators, rounded to bf16, as the A
        // operand; V by ldmatrix.trans.
#pragma unroll
        for (int jj = 0; jj < FK / 16; ++jj) {
            const uint32_t a[4] = {
                pack_bf16(s[2 * jj][0], s[2 * jj][1]),
                pack_bf16(s[2 * jj][2], s[2 * jj][3]),
                pack_bf16(s[2 * jj + 1][0], s[2 * jj + 1][1]),
                pack_bf16(s[2 * jj + 1][2], s[2 * jj + 1][3])};
#pragma unroll
            for (int dp = 0; dp < KC; ++dp) {
                uint32_t b[4];
                ldsm_x4_trans(b, vt + (16 * jj + (mi & 1) * 8 + r8) * LD +
                                     16 * dp + (mi >> 1) * 8);
                mma_bf16(o[2 * dp], a, b[0], b[1]);
                mma_bf16(o[2 * dp + 1], a, b[2], b[3]);
            }
        }
        __syncthreads();                 // this buffer is refilled next
    }

    const float inv_a = 1.0f / fmaxf(quad_sum(l_a), 1e-30f);
    const float inv_b = 1.0f / fmaxf(quad_sum(l_b), 1e-30f);
    __nv_bfloat16 *ob = out + (int64_t)blockIdx.y * sq * hd;
#pragma unroll
    for (int j = 0; j < 2 * KC; ++j) {
        const int d = 8 * j + 2 * t;     // hd % 8 == 0: d + 1 < hd too
        if (d >= hd) continue;
        if (row_a < sq)
            *reinterpret_cast<__nv_bfloat162 *>(ob + (int64_t)row_a * hd + d) =
                __floats2bfloat162_rn(o[j][0] * inv_a, o[j][1] * inv_a);
        if (row_b < sq)
            *reinterpret_cast<__nv_bfloat162 *>(ob + (int64_t)row_b * hd + d) =
                __floats2bfloat162_rn(o[j][2] * inv_b, o[j][3] * inv_b);
    }
}

// ---- float32 on the CUDA cores -------------------------------------------
// NC = ceil(hd / 64): 64-column chunks of the output row.
template <int NC>
__global__ void __launch_bounds__(F32_THREADS, NC == 1 ? 2 : 1)
flash_attention_kernel_f32(const float *__restrict__ q,
                           const float *__restrict__ k,
                           const float *__restrict__ v,
                           float *__restrict__ out, int sq, int sk, int hd,
                           float scale, int causal) {
    const int ld = hd + 4;               // 4 (mod 8) words: no conflicts
    extern __shared__ float4 smf4[];
    float *qs = reinterpret_cast<float *>(smf4);   // [FQ][ld]
    float *ks = qs + FQ * ld;                       // [2][FK][ld]
    float *vs = ks + 2 * FK * ld;                   // [2][FK][ld]
    float *ps = vs + 2 * FK * ld;                   // [FQ][PLD]

    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    const int q0 = (gridDim.x - 1 - blockIdx.x) * FQ;
    const float *qb = q + (int64_t)blockIdx.y * sq * hd;
    const float *kb = k + (int64_t)blockIdx.y * sk * hd;
    const float *vb = v + (int64_t)blockIdx.y * sk * hd;
    const int k_end = causal ? min(sk, q0 + FQ) : sk;
    const int ntiles = (k_end + FK - 1) / FK;

    load_tile(qs, ld, qb, q0, sq, hd, hd, FQ, tid, F32_THREADS);
    load_tile(ks, ld, kb, 0, sk, hd, hd, FK, tid, F32_THREADS);
    load_tile(vs, ld, vb, 0, sk, hd, hd, FK, tid, F32_THREADS);
    cp_commit();

    float o[4][NC][4];
    float m[4], l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = NEG;
        l[i] = 0.0f;
#pragma unroll
        for (int c = 0; c < NC; ++c)
            o[i][c][0] = o[i][c][1] = o[i][c][2] = o[i][c][3] = 0.0f;
    }

    for (int it = 0; it < ntiles; ++it) {
        const int buf = it & 1;
        if (it + 1 < ntiles) {
            const int nb = buf ^ 1;
            load_tile(ks + nb * FK * ld, ld, kb, (it + 1) * FK, sk, hd, hd,
                      FK, tid, F32_THREADS);
            load_tile(vs + nb * FK * ld, ld, vb, (it + 1) * FK, sk, hd, hd,
                      FK, tid, F32_THREADS);
            cp_commit();
            cp_wait<1>();
        } else {
            cp_wait<0>();
        }
        __syncthreads();
        const float *kt = ks + buf * FK * ld;
        const float *vt = vs + buf * FK * ld;

        // S: rows ty + 16 i, keys tx + 16 j.
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
            s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.0f;
#pragma unroll 2
        for (int d = 0; d < hd; d += 4) {
            float4 qv[4], kv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                qv[i] = *reinterpret_cast<const float4 *>(
                    qs + (ty + 16 * i) * ld + d);
#pragma unroll
            for (int j = 0; j < 4; ++j)
                kv[j] = *reinterpret_cast<const float4 *>(
                    kt + (tx + 16 * j) * ld + d);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    float a = s[i][j];
                    a = fmaf(qv[i].x, kv[j].x, a);
                    a = fmaf(qv[i].y, kv[j].y, a);
                    a = fmaf(qv[i].z, kv[j].z, a);
                    s[i][j] = fmaf(qv[i].w, kv[j].w, a);
                }
        }

        const int k0 = it * FK;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int row = q0 + ty + 16 * i;
            float mx = m[i];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int key = k0 + tx + 16 * j;
                s[i][j] = key < sk && (!causal || key <= row)
                              ? s[i][j] * scale : NEG;
                mx = fmaxf(mx, s[i][j]);
            }
            mx = half_max(mx);
            const float corr = expf(m[i] - mx);
            m[i] = mx;
            float sum = 0.0f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float p = expf(s[i][j] - mx);
                ps[(ty + 16 * i) * PLD + tx + 16 * j] = p;
                sum += p;
            }
            l[i] = l[i] * corr + sum;
#pragma unroll
            for (int c = 0; c < NC; ++c) {
                o[i][c][0] *= corr;
                o[i][c][1] *= corr;
                o[i][c][2] *= corr;
                o[i][c][3] *= corr;
            }
        }
        __syncthreads();                 // P complete

        // O += P V: rows ty + 16 i, columns 64 c + 4 tx .. + 3.
#pragma unroll 2
        for (int kk = 0; kk < FK; kk += 4) {
            float4 pv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                pv[i] = *reinterpret_cast<const float4 *>(
                    ps + (ty + 16 * i) * PLD + kk);
#pragma unroll
            for (int c = 0; c < NC; ++c) {
                const int d = 64 * c + 4 * tx;
                if (d >= hd) continue;
                const float4 v0 = *reinterpret_cast<const float4 *>(
                    vt + (kk + 0) * ld + d);
                const float4 v1 = *reinterpret_cast<const float4 *>(
                    vt + (kk + 1) * ld + d);
                const float4 v2 = *reinterpret_cast<const float4 *>(
                    vt + (kk + 2) * ld + d);
                const float4 v3 = *reinterpret_cast<const float4 *>(
                    vt + (kk + 3) * ld + d);
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    float *a = o[i][c];
                    a[0] = fmaf(pv[i].x, v0.x, a[0]);
                    a[1] = fmaf(pv[i].x, v0.y, a[1]);
                    a[2] = fmaf(pv[i].x, v0.z, a[2]);
                    a[3] = fmaf(pv[i].x, v0.w, a[3]);
                    a[0] = fmaf(pv[i].y, v1.x, a[0]);
                    a[1] = fmaf(pv[i].y, v1.y, a[1]);
                    a[2] = fmaf(pv[i].y, v1.z, a[2]);
                    a[3] = fmaf(pv[i].y, v1.w, a[3]);
                    a[0] = fmaf(pv[i].z, v2.x, a[0]);
                    a[1] = fmaf(pv[i].z, v2.y, a[1]);
                    a[2] = fmaf(pv[i].z, v2.z, a[2]);
                    a[3] = fmaf(pv[i].z, v2.w, a[3]);
                    a[0] = fmaf(pv[i].w, v3.x, a[0]);
                    a[1] = fmaf(pv[i].w, v3.y, a[1]);
                    a[2] = fmaf(pv[i].w, v3.z, a[2]);
                    a[3] = fmaf(pv[i].w, v3.w, a[3]);
                }
            }
        }
        __syncthreads();                 // P and this K/V buffer reused
    }

    float *ob = out + (int64_t)blockIdx.y * sq * hd;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty + 16 * i;
        const float inv = 1.0f / fmaxf(half_sum(l[i]), 1e-30f);
        if (row >= sq) continue;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
            const int d = 64 * c + 4 * tx;
            if (d < hd)
                *reinterpret_cast<float4 *>(ob + (int64_t)row * hd + d) =
                    make_float4(o[i][c][0] * inv, o[i][c][1] * inv,
                                o[i][c][2] * inv, o[i][c][3] * inv);
        }
    }
}

namespace {

template <typename K>
int set_smem(K kernel, size_t bytes) {
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int HDP>
int launch_tc(const void *q, const void *k, const void *v, void *out, int bh,
              int sq, int sk, int hd, float scale, int causal,
              cudaStream_t s) {
    const size_t smem = sizeof(__nv_bfloat16) * (size_t)(FQ + 4 * FK) *
                        (HDP + 8);
    const int err = set_smem(flash_attention_kernel_tc<HDP>, smem);
    if (err != 0) return err;
    dim3 grid((unsigned)((sq + FQ - 1) / FQ), (unsigned)bh);
    flash_attention_kernel_tc<HDP><<<grid, TC_THREADS, smem, s>>>(
        (const __nv_bfloat16 *)q, (const __nv_bfloat16 *)k,
        (const __nv_bfloat16 *)v, (__nv_bfloat16 *)out, sq, sk, hd,
        scale * LOG2E, causal);
    return (int)cudaGetLastError();
}

template <int NC>
int launch_f32(const void *q, const void *k, const void *v, void *out,
               int bh, int sq, int sk, int hd, float scale, int causal,
               cudaStream_t s) {
    const size_t smem = sizeof(float) * ((size_t)(FQ + 4 * FK) * (hd + 4) +
                                         (size_t)FQ * PLD);
    const int err = set_smem(flash_attention_kernel_f32<NC>, smem);
    if (err != 0) return err;
    dim3 grid((unsigned)((sq + FQ - 1) / FQ), (unsigned)bh);
    flash_attention_kernel_f32<NC><<<grid, F32_THREADS, smem, s>>>(
        (const float *)q, (const float *)k, (const float *)v, (float *)out,
        sq, sk, hd, scale, causal);
    return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32 (CUDA cores), 1 bfloat16 (tensor cores); q, k, v and
// out share it and start on 16-byte boundaries. hd % 8 == 0,
// 8 <= hd <= 128, 1 <= bh <= 65535, sq, sk >= 1 (checked by the wrapper).
extern "C" int flash_attention_launch(const void *q, const void *k,
                                      const void *v, void *out, int bh,
                                      int sq, int sk, int hd, float scale,
                                      int causal, int dtype, void *stream) {
    if (bh <= 0 || bh > 65535 || sq <= 0 || sk <= 0 || hd <= 0 ||
        hd > 128 || hd % 8 != 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0) {
        if (hd <= 64)
            return launch_f32<1>(q, k, v, out, bh, sq, sk, hd, scale, causal,
                                 s);
        return launch_f32<2>(q, k, v, out, bh, sq, sk, hd, scale, causal, s);
    }
    if (dtype == 1) {
        if (hd <= 32)
            return launch_tc<32>(q, k, v, out, bh, sq, sk, hd, scale, causal,
                                 s);
        if (hd <= 64)
            return launch_tc<64>(q, k, v, out, bh, sq, sk, hd, scale, causal,
                                 s);
        return launch_tc<128>(q, k, v, out, bh, sq, sk, hd, scale, causal, s);
    }
    return (int)cudaErrorInvalidValue;
}

extern "C" const char *kernel_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
