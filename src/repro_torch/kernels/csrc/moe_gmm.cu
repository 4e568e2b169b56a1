// K4 on Hopper: the grouped matmul of SW+ MoE dispatch,
// out[i] = x[i] @ w[block_expert[i / bm]] for i < n_rows, 0 past it,
// float32 accumulation, the result cast to x's dtype.
//
// Replaces src/repro/kernels/moe_gmm.py::_gmm_kernel (the Pallas kernel
// behind gmm). There, an (M/BM, N/BN, K/BK) grid walks K innermost,
// carrying a float32 (BM, BN) accumulator in VMEM from one grid step to
// the next, and block_expert is scalar-prefetched so each step's weight
// BlockSpec DMAs the right expert's (BK, BN) tile; K and N are
// zero-padded to tile multiples.
//
// Bound on this card: at the serve path's decode shapes, bytes. With the
// row blocks past n_rows skipped, one launch multiplies at most 16 blocks
// of 128 rows (4 slots x top-4) by 16 experts' (2048 x 1408) weights:
// 11.8 GFLOP (0.012 ms at the tensor cores' 989 TFLOP/s) against 92 MB of
// weights (0.028 ms at 3.35 TB/s). Without the skip the launch would be
// 47.2 GFLOP over all 8,192 rows of t_pad, which sort_by_expert sizes
// from shapes alone.
//
// Two routes, chosen by the wrapper (kernels/moe_gmm.py) and named there:
//
// * tensor cores (bf16, K and N multiples of 8, 16-byte aligned
//   pointers): gmm_kernel_tc. One CTA per (64 WG) x 128 output tile, WG =
//   2 consumer warpgroups when bm is a multiple of 128, else 1, each
//   running wgmma.mma_async.m64n128k16.f32.bf16.bf16 on 64 rows. A ring of
//   STAGES shared-memory stages holds (64 WG x 64) x tiles and (64 x 128)
//   weight tiles, both in the 128-byte swizzle that TMA writes and wgmma
//   reads; thread 0 refills a stage with TMA loads as soon as its products
//   are done, so all the other stages stay loading, each completing on its
//   own mbarrier. The weights are loaded with an evict-first L2 policy and
//   the x tiles, which the CTAs of the other column tiles read again, with
//   evict-last, so that x stays in L2 while up to 92 MB of weights stream
//   past it. The weight tile comes from
//   w[block_expert[row0 / bm]]: the CTA reads its expert itself, which
//   takes the place of the TPU's scalar prefetch. w stays (E, K, N) with N
//   contiguous (wgmma's transpose bit for B takes that layout as it is, so
//   no copy of the weights is made); its TMA map is 3-D, (N, K, E), so a
//   box zero-fills past N and past its own expert's K rows. x's 2-D map
//   zero-fills past K. Each thread keeps a 64 x 128 slice of the
//   accumulator in 64 float32 registers.
// * CUDA cores (float32, and bf16 shapes TMA cannot describe):
//   gmm_kernel, one block per 64 x 64 output tile, a K loop through shared
//   memory 32 at a time, 4 x 4 sums per thread in float32, the ragged N
//   and K edges masked in the loads and the store. The float32 serve is
//   held to its golden file at rtol 2e-5, which TF32 cannot meet.
//
// Both skip the row blocks that hold no token: n_rows (a device int32, or
// null for every row) counts the leading rows that belong to a group. A
// block whose first row is at or past it writes zeros (streaming stores)
// and exits; rows at or past it inside a block are stored as zeros. The
// count is read on the device, so nothing waits on the host and the grid
// stays sized from shapes.
//
// Build (what kernels/_lib.py runs):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xptxas -v
//        -shared -Xcompiler -fPIC -o libmoe_gmm.so moe_gmm.cu -ldl
//
// The entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() of the launch, or a
// negative code when the TMA maps cannot be made (kernel_error_string).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

// ---- CUDA-core route -----------------------------------------------------
constexpr int BM = 64;   // output rows per block
constexpr int BN = 64;   // output columns per block
constexpr int BK = 32;   // K per shared-memory stage
constexpr int TM = 4;    // rows per thread
constexpr int TN = 4;    // columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);   // 256

// ---- tensor-core route ---------------------------------------------------
constexpr int TC_BN = 128;     // output columns per CTA (one wgmma's N)
constexpr int TC_BK = 64;      // K per stage: 128 bytes, one swizzle row
constexpr int TC_B_BYTES = TC_BK * TC_BN * 2;    // weight tile, 16 KB

template <int WG> struct Tc {
    static constexpr int ROWS = 64 * WG;                 // output rows per CTA
    static constexpr int STAGES = WG == 2 ? 3 : 4;
    static constexpr int A_BYTES = ROWS * TC_BK * 2;     // x tile
    static constexpr int STAGE_BYTES = A_BYTES + TC_B_BYTES;
    // Stages, their mbarriers, and 1 KB to align the ring to the 1024
    // bytes the 128-byte swizzle repeats over: 97 KB for either WG, so two
    // CTAs share an SM.
    static constexpr int SMEM = STAGES * STAGE_BYTES + 8 * STAGES + 1024;
};

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

__device__ __forceinline__ int64_t row_limit(const int32_t *n_rows,
                                             int64_t m) {
    if (n_rows == nullptr) return m;
    const int64_t r = *n_rows;
    return r < 0 ? 0 : (r > m ? m : r);
}

__device__ __forceinline__ uint32_t smem_u32(const void *p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    const long long t0 = clock64();
    for (;;) {
        uint32_t ok;
        asm volatile(
            "{\n .reg .pred p;\n"
            " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
        if (ok) return;
        // A TMA load that never lands (a bad map) traps after ~2 s instead
        // of hanging the card.
        if (clock64() - t0 > (1ll << 32)) __trap();
    }
}

__device__ __forceinline__ uint64_t policy_evict_first() {
    uint64_t p;
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
                 : "=l"(p));
    return p;
}

__device__ __forceinline__ uint64_t policy_evict_last() {
    uint64_t p;
    asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
                 : "=l"(p));
    return p;
}

// TMA loads with an L2 policy: the weights stream through once (evict
// first); the x tiles are read again by the CTAs of the other column tiles
// (evict last).
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap *map,
                                       uint32_t bar, int c0, int c1,
                                       uint64_t policy) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes.L2::cache_hint [%0], [%1, {%3, %4}], [%2], %5;"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
           "r"(c0), "r"(c1), "l"(policy) : "memory");
}

__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap *map,
                                       uint32_t bar, int c0, int c1, int c2,
                                       uint64_t policy) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes.L2::cache_hint [%0], [%1, {%3, %4, %5}], [%2], "
        "%6;"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
           "r"(c0), "r"(c1), "r"(c2), "l"(policy) : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
    return (uint64_t)((addr & 0x3FFFF) >> 4)
         | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16)
         | ((uint64_t)((sbo >> 4) & 0x3FFF) << 32)
         | (1ull << 62);
}

#define ACC8(i) "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), \
    "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), \
    "+f"(d[i + 7])

// D (64 x 128, float32, registers) += A (64 x 16, K-major) . B (16 x 128,
// N-major: the transpose bit is set), both bf16 in shared memory.
__device__ __forceinline__ void wgmma_m64n128k16(float *d, uint64_t da,
                                                 uint64_t db) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 1;\n"
        "}\n"
        : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40),
          ACC8(48), ACC8(56)
        : "l"(da), "l"(db), "n"(1));
}

#undef ACC8

// Keeps the compiler from moving reads or writes of the accumulator
// across the wgmma fences and waits.
__device__ __forceinline__ void fence_acc(float *d) {
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

}  // namespace

// x: (m, k); w: (n_experts, k, n); block_expert: (m / bm,); out: (m, n).
// m % bm == 0 and bm % BM == 0 (checked by the wrapper).
template <typename T>
__global__ void __launch_bounds__(THREADS)
gmm_kernel(const T *__restrict__ x, const T *__restrict__ w,
           const int32_t *__restrict__ block_expert,
           const int32_t *__restrict__ n_rows, T *__restrict__ out,
           int64_t m, int64_t k, int64_t n, int64_t n_experts, int64_t bm) {
    __shared__ float xs[BK][BM + 4];   // x tile, K-major: xs[kk][row]
    __shared__ float ws[BK][BN + 4];   // weight tile: ws[kk][col]

    const int64_t row0 = (int64_t)blockIdx.y * BM;
    const int64_t col0 = (int64_t)blockIdx.x * BN;
    const int64_t limit = row_limit(n_rows, m);
    const int tid = threadIdx.x;
    if (row0 >= limit) {               // a block past the last group
        for (int q = tid; q < BM * BN; q += THREADS) {
            const int64_t c = col0 + q % BN;
            if (c < n) out[(row0 + q / BN) * n + c] = from_f32<T>(0.0f);
        }
        return;
    }
    int64_t e = block_expert[row0 / bm];
    e = e < 0 ? 0 : (e >= n_experts ? n_experts - 1 : e);
    const T *we = w + e * k * n;
    const T *xb = x + row0 * k;

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
        const bool live = r < limit;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            const int64_t c = col0 + tx * TN + j;
            if (c < n) out[r * n + c] = from_f32<T>(live ? acc[i][j] : 0.0f);
        }
    }
}

// The tensor-core route: x, w and out bf16; k % 8 == 0, n % 8 == 0 and
// (m / (64 WG)) blocks of rows; tx maps x as (K, M) with (64, 64 WG)
// boxes, tw maps w as (N, K, E) with (64, 64, 1) boxes, both 128-byte
// swizzled and zero-filled out of bounds.
template <int WG>
__global__ void __launch_bounds__(128 * WG, 2)
gmm_kernel_tc(const __grid_constant__ CUtensorMap tx,
              const __grid_constant__ CUtensorMap tw,
              const int32_t *__restrict__ block_expert,
              const int32_t *__restrict__ n_rows,
              __nv_bfloat16 *__restrict__ out, int m, int k, int n,
              int n_experts, int bm) {
    using C = Tc<WG>;
    constexpr int STAGES = C::STAGES;
    const int tid = threadIdx.x;
    const int row0 = blockIdx.y * C::ROWS;
    const int col0 = blockIdx.x * TC_BN;
    const int limit = (int)row_limit(n_rows, m);

    if (row0 >= limit) {               // a block past the last group
        const int cols = min(TC_BN, n - col0);     // a multiple of 8
        const int chunks = cols / 8;
        const uint4 zero = make_uint4(0, 0, 0, 0);
        for (int q = tid; q < C::ROWS * chunks; q += 128 * WG) {
            const int r = q / chunks, c = q % chunks;
            __stcs(reinterpret_cast<uint4 *>(          // streaming store
                       out + (int64_t)(row0 + r) * n + col0 + 8 * c),
                   zero);
        }
        return;
    }
    int e = block_expert[row0 / bm];
    e = e < 0 ? 0 : (e >= n_experts ? n_experts - 1 : e);

    extern __shared__ uint8_t smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t ring = (raw + 1023u) & ~1023u;    // 1024-byte aligned
    // stage s: x tile at ring + s * STAGE_BYTES, weight tile right after;
    // barriers after the last stage.
    const uint32_t bars = ring + STAGES * C::STAGE_BYTES;
    const int ktiles = (k + TC_BK - 1) / TC_BK;

    // The weight tile's second 64-column half is loaded only where it
    // starts inside N; past N the stage keeps stale columns, which reach
    // only output columns that are never stored.
    const bool half2 = col0 + 64 < n;
    const uint32_t stage_tx = C::STAGE_BYTES - (half2 ? 0 : TC_B_BYTES / 2);
    const CUtensorMap *mx = &tx, *mw = &tw;
    const uint64_t keep = policy_evict_last(), stream = policy_evict_first();
    auto issue = [=](int kt) {         // thread 0: TMA loads of k-tile kt
        const int s = kt % STAGES;
        const uint32_t a = ring + s * C::STAGE_BYTES;
        const uint32_t b = a + C::A_BYTES;
        const uint32_t bar = bars + 8 * s;
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                     :: "r"(bar), "r"(stage_tx) : "memory");
        tma_2d(a, mx, bar, kt * TC_BK, row0, keep);
        tma_3d(b, mw, bar, col0, kt * TC_BK, e, stream);
        if (half2)
            tma_3d(b + TC_B_BYTES / 2, mw, bar, col0 + 64, kt * TC_BK, e,
                   stream);
    };

    if (tid == 0) {
        for (int s = 0; s < STAGES; ++s)
            asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                         :: "r"(bars + 8 * s) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (tid == 0)
        for (int kt = 0; kt < STAGES && kt < ktiles; ++kt) issue(kt);

    const int wg = tid / 128;
    float d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0.0f;
    fence_acc(d);

    for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % STAGES;
        mbar_wait(bars + 8 * s, (kt / STAGES) & 1);
        __syncwarp();
        fence_acc(d);
        const uint32_t a = ring + s * C::STAGE_BYTES + wg * 64 * 128;
        const uint32_t b = ring + s * C::STAGE_BYTES + C::A_BYTES;
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < TC_BK / 16; ++kk) {
            // A: K-major, 8-row groups 1024 bytes apart, k16 steps 32
            // bytes along the swizzled row. B: N-major, 64-column halves
            // 8 KB apart (LBO), 8-row groups of K 1024 bytes apart (SBO),
            // k16 steps 16 rows of 128 bytes.
            wgmma_m64n128k16(d, sw128_desc(a + 32 * kk, 16, 1024),
                             sw128_desc(b + 2048 * kk, TC_B_BYTES / 2, 1024));
        }
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
        // Once every warpgroup's products of k-tile kt are done, its stage
        // is refilled with k-tile kt + STAGES: the other stages stay
        // loading meanwhile (the route is bound by bytes at decode, and
        // keeping one more group of products in flight instead gained
        // nothing on the card).
        asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
        fence_acc(d);
        __syncthreads();
        if (tid == 0 && kt + STAGES < ktiles) issue(kt + STAGES);
    }

    // Accumulator layout of m64nNk16: warp w of the warpgroup holds rows
    // 16 w + lane / 4 (+ 8); d[4 j + {0, 1}] are columns 8 j + 2 (lane % 4)
    // (+ 1) of the first row, d[4 j + {2, 3}] the same of the second.
    const int lane = tid % 32, warp = (tid % 128) / 32;
    const int r_lo = row0 + wg * 64 + warp * 16 + lane / 4;
    const bool live_lo = r_lo < limit, live_hi = r_lo + 8 < limit;
#pragma unroll
    for (int j = 0; j < TC_BN / 8; ++j) {
        const int c = col0 + 8 * j + 2 * (lane % 4);
        if (c < n) {                   // n % 8 == 0: c + 1 < n as well
            *reinterpret_cast<__nv_bfloat162 *>(out + (int64_t)r_lo * n + c) =
                __floats2bfloat162_rn(live_lo ? d[4 * j] : 0.0f,
                                      live_lo ? d[4 * j + 1] : 0.0f);
            *reinterpret_cast<__nv_bfloat162 *>(
                out + (int64_t)(r_lo + 8) * n + c) =
                __floats2bfloat162_rn(live_hi ? d[4 * j + 2] : 0.0f,
                                      live_hi ? d[4 * j + 3] : 0.0f);
        }
    }
}

namespace {

// Error codes of the tensor-core route's host side (negative, so they
// never collide with a cudaError_t).
constexpr int ERR_NO_ENCODE = -1;        // no cuTensorMapEncodeTiled
constexpr int ERR_ENCODE = -1000;        // -1000 - CUresult of a failed map

typedef CUresult (*EncodeTiled)(CUtensorMap *, CUtensorMapDataType,
                                cuuint32_t, void *, const cuuint64_t *,
                                const cuuint64_t *, const cuuint32_t *,
                                const cuuint32_t *, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, from the libcuda.so.1 that the CUDA runtime has
// loaded (no link against libcuda is needed).
EncodeTiled encoder() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void *h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
        if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_NOW);
        if (h != nullptr)
            fn = (EncodeTiled)dlsym(h, "cuTensorMapEncodeTiled");
    }
    return fn;
}

int encode(EncodeTiled fn, CUtensorMap *map, cuuint32_t rank, const void *p,
           const cuuint64_t *dims, const cuuint64_t *strides,
           const cuuint32_t *box) {
    const cuuint32_t ones[3] = {1, 1, 1};
    const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                          const_cast<void *>(p), dims, strides, box, ones,
                          CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : ERR_ENCODE - (int)r;
}

template <int WG>
int launch_tc(const void *x, const void *w, const void *block_expert,
              const void *n_rows, void *out, int64_t m, int64_t k,
              int64_t n, int64_t n_experts, int64_t bm, cudaStream_t s) {
    using C = Tc<WG>;
    EncodeTiled fn = encoder();
    if (fn == nullptr) return ERR_NO_ENCODE;
    CUtensorMap mx, mw;
    const cuuint64_t xdims[2] = {(cuuint64_t)k, (cuuint64_t)m};
    const cuuint64_t xstrides[1] = {(cuuint64_t)k * 2};
    const cuuint32_t xbox[2] = {TC_BK, (cuuint32_t)C::ROWS};
    int err = encode(fn, &mx, 2, x, xdims, xstrides, xbox);
    if (err != 0) return err;
    const cuuint64_t wdims[3] = {(cuuint64_t)n, (cuuint64_t)k,
                                 (cuuint64_t)n_experts};
    const cuuint64_t wstrides[2] = {(cuuint64_t)n * 2,
                                    (cuuint64_t)k * n * 2};
    const cuuint32_t wbox[3] = {64, TC_BK, 1};
    err = encode(fn, &mw, 3, w, wdims, wstrides, wbox);
    if (err != 0) return err;
    cudaError_t e = cudaFuncSetAttribute(
        gmm_kernel_tc<WG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::SMEM);
    if (e != cudaSuccess) return (int)e;
    dim3 grid((unsigned)((n + TC_BN - 1) / TC_BN), (unsigned)(m / C::ROWS));
    gmm_kernel_tc<WG><<<grid, 128 * WG, C::SMEM, s>>>(
        mx, mw, (const int32_t *)block_expert, (const int32_t *)n_rows,
        (__nv_bfloat16 *)out, (int)m, (int)k, (int)n, (int)n_experts,
        (int)bm);
    return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, w and out share it). route: 0 the
// CUDA cores, 1 the tensor cores (bf16, k % 8 == 0, n % 8 == 0, 16-byte
// aligned x, w and out: checked by the wrapper). n_rows may be null (every
// row).
extern "C" int gmm_launch(const void *x, const void *w,
                          const void *block_expert, const void *n_rows,
                          void *out, int64_t m, int64_t k, int64_t n,
                          int64_t n_experts, int64_t bm, int dtype,
                          int route, void *stream) {
    if (m % BM != 0 || bm % BM != 0 || m / BM > 65535 || m <= 0 || n <= 0 ||
        k <= 0 || n_experts <= 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (route == 1) {
        if (dtype != 1 || k % 8 != 0 || n % 8 != 0 || m > INT32_MAX ||
            k > INT32_MAX || n > INT32_MAX || n_experts > INT32_MAX)
            return (int)cudaErrorInvalidValue;
        if (bm % 128 == 0)
            return launch_tc<2>(x, w, block_expert, n_rows, out, m, k, n,
                                n_experts, bm, s);
        return launch_tc<1>(x, w, block_expert, n_rows, out, m, k, n,
                            n_experts, bm, s);
    }
    if (route != 0) return (int)cudaErrorInvalidValue;
    dim3 grid((unsigned)((n + BN - 1) / BN), (unsigned)(m / BM));
    if (dtype == 0) {
        gmm_kernel<float><<<grid, THREADS, 0, s>>>(
            (const float *)x, (const float *)w, (const int32_t *)block_expert,
            (const int32_t *)n_rows, (float *)out, m, k, n, n_experts, bm);
    } else if (dtype == 1) {
        gmm_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
            (const __nv_bfloat16 *)x, (const __nv_bfloat16 *)w,
            (const int32_t *)block_expert, (const int32_t *)n_rows,
            (__nv_bfloat16 *)out, m, k, n, n_experts, bm);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

extern "C" const char *kernel_error_string(int code) {
    if (code == ERR_NO_ENCODE)
        return "cuTensorMapEncodeTiled not found in libcuda.so.1";
    if (code <= ERR_ENCODE) return "cuTensorMapEncodeTiled refused a map";
    return cudaGetErrorString((cudaError_t)code);
}
