// K6 on Hopper: the Mamba2 SSD chunked scan with the state starting at 0
// and no D-skip. Per chunk of Q steps, with cs = cumsum(da):
//   y = (C B^T o L) xdt + (C o exp(cs)) h_prev^T,  L[i,j] = exp(cs_i - cs_j)
//       for j <= i, else 0;
//   h = h_prev * exp(cs_last) + xdt^T (B o exp(cs_last - cs)),
// h carried from chunk to chunk in float32, y cast to xdt's dtype.
//
// Replaces src/repro/kernels/ssd_scan.py::_ssd_kernel (the Pallas kernel
// behind ssd_scan_kernel). There, a (BH, S/Q) grid walks the chunk axis
// innermost ("arbitrary"), carrying h (P x N, float32) in VMEM scratch from
// one grid step to the next, and forms the Q x Q matrix C B^T o L whole.
//
// Bound on this card: operations. Per (bh, chunk) Q(Q+1)(N + P) + 4QPN
// FLOPs (C B^T and its product with xdt only where j <= i, as formed
// below) against 4 bytes per element read or written: at mamba2-780m's
// width (BH 48, S 4096, P 64, N 128, Q 256, float32) 16.1 GFLOP against
// 303 MB, about 0.241 ms at the 67 TFLOP/s of float32 outside the tensor
// cores (a 2e-4 tolerance on float32 inputs rules out TF32). This version
// stays on the CUDA cores in float32; tensor-core tiles are later work.
//
// Design. Blocks run in parallel in no order, so the TPU's sequential
// chunk axis cannot be a grid axis here. One block per (bh, P-slice)
// walking its chunks in a loop (h in shared memory) gives only BH x P/32
// blocks: 32 at the kernel-bench shape and 96 at mamba2-780m's, for 132
// SMs; such a kernel measured 3.1 and 7.1 ms there (chip_smoke.py, one
// H100). So one block owns one (bh, chunk), and only the state, which is
// P x N, is handed from chunk to chunk, the way a single-pass scan hands
// on its prefix:
//   1. the block's own state contribution S = xdt^T (B o exp(cs_last - cs))
//      (h_prev = 0), in shared memory;
//   2. it waits for its predecessor (same bh, chunk - 1) to publish
//      h_prev in a global scratch (flag per chunk, bounded spin), then
//      publishes h = h_prev exp(cs_last) + S at once, so the chain from
//      chunk to chunk costs one P x N read and write;
//   3. then y, with h_prev in shared memory: the intra-chunk part and
//      (C o exp(cs)) h_prev^T.
// Blocks take (bh, chunk) in the order they start, from an atomic ticket,
// so a block's predecessor has always started before it and the wait
// cannot deadlock; the spin is bounded all the same, and a block that
// waits past the bound traps, so the launch fails at the next synchronise
// instead of hanging the card or reading an unwritten state. The Q x Q matrix is never
// formed (256 KB at Q 256, above a block's 227 KB): rows i go in tiles of
// 32, and for each row tile the column tiles j <= i, 32 at a time, give a
// 32 x 32 tile G = C_i B_j^T o L in shared memory (each thread a 2 x 2
// corner of it) that is folded into y_i at once. Each thread keeps 2 rows
// x P/16 columns of y_i, and 4 rows of S at one column, in registers, so
// one shared-memory load serves 2-4 products. L is masked before the
// exp: for j > i, cs_i - cs_j > 0 and its exp can overflow, and inf * 0 is
// NaN, so only j <= i is ever exponentiated. Ragged edges (P = 50, Q below
// 32, any N up to 128) are masked in the loads and stores, not padded.
// Rows of B, C and h sit at a stride of N rounded up to odd, so the 32
// lanes reading 32 rows hit 32 banks. The cumulative sum of da runs left
// to right in one thread, and starts anew in every chunk, so its rounding
// does not build up over the 16-32 chunks of a sequence beyond what the
// decay of h carries (a relative 1e-7 per chunk).
//
// Build (what kernels/_lib.py runs):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xptxas -v
//        -shared -Xcompiler -fPIC -o libssd_scan.so ssd_scan.cu
//
// The entry point launches on the caller's stream, allocates nothing
// (the wrapper passes the zeroed ticket and flags and the state scratch),
// does not synchronise, and returns cudaGetLastError() of the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TI = 32;                 // rows i per tile
constexpr int TJ = 32;                 // columns j per tile
constexpr int THREADS = 256;
constexpr int MAX_N = 128;
constexpr int MAX_P = 128;
constexpr int MAX_Q = 1024;
constexpr int YC = MAX_P / 16;         // y columns per thread, at most
constexpr long long MAX_SPINS = 1LL << 26;           // >= 2 s of waiting

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

size_t smem_bytes(int q, int p, int n) {
    const int ns = n | 1;
    return sizeof(float) * (2 * (size_t)q + (size_t)TI * ns +
                            (size_t)TJ * ns + (size_t)TJ * p +
                            (size_t)TI * (TJ + 1) + (size_t)p * ns);
}

// Rows [j0, j0 + TJ) of the chunk: B (each row times w[j], when w is
// given) into bts (stride ns), xdt into xts (stride p); rows past q are 0.
template <typename T>
__device__ __forceinline__ void load_bx(const T *bb, const T *xb, float *bts,
                                        float *xts, const float *w,
                                        int64_t t0, int j0, int q, int p,
                                        int n, int ns) {
    for (int e = threadIdx.x; e < TJ * n; e += THREADS) {
        const int r = e / n, k = e % n;
        bts[r * ns + k] =
            j0 + r < q ? to_f32(bb[(t0 + j0 + r) * n + k]) *
                             (w ? w[j0 + r] : 1.0f)
                       : 0.0f;
    }
    for (int e = threadIdx.x; e < TJ * p; e += THREADS) {
        const int r = e / p;
        xts[e] = j0 + r < q ? to_f32(xb[(t0 + j0 + r) * p + e % p]) : 0.0f;
    }
}

}  // namespace

// xdt: (bh, s, p); da: (bh, s); b, c: (bh, s, n); y: (bh, s, p).
// states: (bh * s/q, p, n) float32 scratch; sync: [ticket, flag per
// (bh, chunk)], zeroed. s % q == 0, q <= MAX_Q, n <= MAX_N, p <= MAX_P.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const T *__restrict__ xdt, const T *__restrict__ da,
                const T *__restrict__ b, const T *__restrict__ c,
                T *__restrict__ y, float *states, int *sync,
                int s, int p, int n, int q) {
    extern __shared__ float smem[];
    __shared__ int ticket;
    const int ns = n | 1;
    float *cs = smem;                       // [q] cumsum of da in the chunk
    float *w = cs + q;                      // [q] exp(cs_last - cs_j)
    float *cts = w + q;                     // [TI][ns] C rows
    float *bts = cts + TI * ns;             // [TJ][ns] B rows
    float *xts = bts + TJ * ns;             // [TJ][p] xdt rows
    float *g = xts + TJ * p;                // [TI][TJ + 1]
    float *hs = g + TI * (TJ + 1);          // [p][ns] S, then h_prev

    const int tid = threadIdx.x;
    if (tid == 0) ticket = atomicAdd(sync, 1);
    __syncthreads();
    const int nc = s / q;
    const int t = ticket;                   // (bh, chunk) in start order
    const int64_t bh = t / nc;
    const int ci = t % nc;
    const int64_t t0 = (int64_t)ci * q;
    const T *xb = xdt + bh * s * p;
    const T *dab = da + bh * s;
    const T *bb = b + bh * s * n;
    const T *cb = c + bh * s * n;
    T *yb = y + bh * s * p;
    int *flags = sync + 1;
    const int pn = p * n;

    for (int i = tid; i < q; i += THREADS) cs[i] = to_f32(dab[t0 + i]);
    for (int e = tid; e < pn; e += THREADS) hs[(e / n) * ns + e % n] = 0.0f;
    __syncthreads();
    if (tid == 0) {
        float acc = 0.0f;
        for (int i = 0; i < q; ++i) {
            acc += cs[i];
            cs[i] = acc;
        }
    }
    __syncthreads();
    const float cs_last = cs[q - 1];
    for (int i = tid; i < q; i += THREADS) w[i] = expf(cs_last - cs[i]);

    // ---- 1. S = xdt^T (B o exp(cs_last - cs)) ----------------------------
    // Each thread sums four rows p0..p0+3 of S at one column k, so one load
    // of B serves four products. Rows past p read the next row of xts (or
    // the start of g), and are dropped.
    const int pq = (p + 3) / 4;
    for (int j0 = 0; j0 < q; j0 += TJ) {
        __syncthreads();                       // previous tiles consumed
        load_bx(bb, xb, bts, xts, w, t0, j0, q, p, n, ns);
        __syncthreads();
        for (int e = tid; e < pq * n; e += THREADS) {
            const int p0 = 4 * (e / n), k = e % n;
            float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
            for (int jj = 0; jj < TJ; ++jj) {
                const float bv = bts[jj * ns + k];
                const float *xr = xts + jj * p + p0;
                s0 += xr[0] * bv;
                s1 += xr[1] * bv;
                s2 += xr[2] * bv;
                s3 += xr[3] * bv;
            }
            const float sa[4] = {s0, s1, s2, s3};
#pragma unroll
            for (int a = 0; a < 4; ++a)
                if (p0 + a < p) hs[(p0 + a) * ns + k] += sa[a];
        }
    }

    // ---- 2. h_prev from the predecessor; publish h -----------------------
    if (ci > 0 && tid == 0) {
        const volatile int *f = flags + t - 1;
        for (long long i = 0; *f == 0; ++i) {
            if (i == MAX_SPINS) __trap();      // the predecessor is lost
            __nanosleep(32);
        }
        __threadfence();
    }
    __syncthreads();
    {
        const float decay = expf(cs_last);
        const float *hprev = states + (int64_t)(t - 1) * pn;
        float *hout = states + (int64_t)t * pn;
        for (int e = tid; e < pn; e += THREADS) {
            const int at = (e / n) * ns + e % n;
            const float hp = ci > 0 ? __ldcg(hprev + e) : 0.0f;
            hout[e] = hp * decay + hs[at];
            hs[at] = hp;
        }
        __threadfence();
        __syncthreads();
        if (tid == 0) atomicExch(flags + t, 1);
    }

    // ---- 3. y, one tile of TI rows at a time -----------------------------
    // Thread (ty, tx) of 16 x 16: rows 2ty and 2ty+1 of the tile; of y,
    // columns tx + 16 cc (cc < yc), of G columns 2tx and 2tx+1.
    const int ty = tid / 16, tx = tid % 16;
    const int r0 = 2 * ty, yc = (p + 15) / 16;
    for (int i0 = 0; i0 < q; i0 += TI) {
        for (int e = tid; e < TI * n; e += THREADS) {
            const int r = e / n, k = e % n;
            cts[r * ns + k] =
                i0 + r < q ? to_f32(cb[(t0 + i0 + r) * n + k]) : 0.0f;
        }
        __syncthreads();
        // (C o exp(cs)) h_prev^T
        float yacc[2][YC];
#pragma unroll
        for (int cc = 0; cc < YC; ++cc) yacc[0][cc] = yacc[1][cc] = 0.0f;
        for (int k = 0; k < n; ++k) {
            const float c0 = cts[r0 * ns + k], c1 = cts[(r0 + 1) * ns + k];
#pragma unroll
            for (int cc = 0; cc < YC; ++cc) {
                const int pp = tx + 16 * cc;
                if (cc < yc) {
                    const float hv = pp < p ? hs[pp * ns + k] : 0.0f;
                    yacc[0][cc] += c0 * hv;
                    yacc[1][cc] += c1 * hv;
                }
            }
        }
#pragma unroll
        for (int a = 0; a < 2; ++a) {
            const float e_cs = i0 + r0 + a < q ? expf(cs[i0 + r0 + a]) : 0.0f;
#pragma unroll
            for (int cc = 0; cc < YC; ++cc) yacc[a][cc] *= e_cs;
        }
        for (int j0 = 0; j0 <= i0; j0 += TJ) {
            __syncthreads();                   // previous tiles consumed
            load_bx(bb, xb, bts, xts, (const float *)nullptr, t0, j0, q, p,
                    n, ns);
            __syncthreads();
            // G = C_i B_j^T o L, a 2 x 2 corner per thread.
            {
                const int c0 = 2 * tx;
                float a00 = 0.0f, a01 = 0.0f, a10 = 0.0f, a11 = 0.0f;
                for (int k = 0; k < n; ++k) {
                    const float x0 = cts[r0 * ns + k];
                    const float x1 = cts[(r0 + 1) * ns + k];
                    const float y0 = bts[c0 * ns + k];
                    const float y1 = bts[(c0 + 1) * ns + k];
                    a00 += x0 * y0;
                    a01 += x0 * y1;
                    a10 += x1 * y0;
                    a11 += x1 * y1;
                }
                const float acc[2][2] = {{a00, a01}, {a10, a11}};
#pragma unroll
                for (int a = 0; a < 2; ++a)
#pragma unroll
                    for (int bcol = 0; bcol < 2; ++bcol) {
                        const int i = i0 + r0 + a, j = j0 + c0 + bcol;
                        g[(r0 + a) * (TJ + 1) + c0 + bcol] =
                            (j <= i && i < q)
                                ? acc[a][bcol] * expf(cs[i] - cs[j])
                                : 0.0f;
                    }
            }
            __syncthreads();
            // y += G xdt_j. Columns past p read the next row of xts (or
            // the start of g), and are dropped.
            for (int jj = 0; jj < TJ; ++jj) {
                const float g0 = g[r0 * (TJ + 1) + jj];
                const float g1 = g[(r0 + 1) * (TJ + 1) + jj];
#pragma unroll
                for (int cc = 0; cc < YC; ++cc) {
                    if (cc < yc) {
                        const float xv = xts[jj * p + tx + 16 * cc];
                        yacc[0][cc] += g0 * xv;
                        yacc[1][cc] += g1 * xv;
                    }
                }
            }
        }
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
            for (int cc = 0; cc < YC; ++cc) {
                const int i = i0 + r0 + a, pp = tx + 16 * cc;
                if (cc < yc && i < q && pp < p)
                    yb[(t0 + i) * p + pp] = from_f32<T>(yacc[a][cc]);
            }
        __syncthreads();                       // cts consumed
    }
}

namespace {

template <typename T>
int launch(const void *xdt, const void *da, const void *b, const void *c,
           void *y, void *states, void *sync, int bh, int s, int p, int n,
           int q, cudaStream_t st) {
    const size_t smem = smem_bytes(q, p, n);
    cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const unsigned blocks = (unsigned)((int64_t)bh * (s / q));
    ssd_scan_kernel<T><<<blocks, THREADS, smem, st>>>(
        (const T *)xdt, (const T *)da, (const T *)b, (const T *)c, (T *)y,
        (float *)states, (int *)sync, s, p, n, q);
    return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (xdt, da, b, c and y share it). states:
// bh * s/q * p * n floats; sync: 1 + bh * s/q ints, zeroed.
extern "C" int ssd_scan_launch(const void *xdt, const void *da,
                               const void *b, const void *c, void *y,
                               void *states, void *sync, int bh, int s,
                               int p, int n, int q, int dtype,
                               void *stream) {
    if (bh <= 0 || s <= 0 || p <= 0 || p > MAX_P || n <= 0 || n > MAX_N ||
        q <= 0 || q > MAX_Q || s % q != 0 ||
        (int64_t)bh * (s / q) > 0x7fffffff)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (dtype == 0)
        return launch<float>(xdt, da, b, c, y, states, sync, bh, s, p, n, q,
                             st);
    if (dtype == 1)
        return launch<__nv_bfloat16>(xdt, da, b, c, y, states, sync, bh, s,
                                     p, n, q, st);
    return (int)cudaErrorInvalidValue;
}

extern "C" const char *kernel_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
