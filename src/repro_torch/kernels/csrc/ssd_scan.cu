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
// FLOPs (C B^T and its product with xdt only where j <= i) against 4 bytes
// per element read or written: at mamba2-780m's width (BH 48, S 4096, P
// 64, N 128, Q 256, float32) 16.1 GFLOP against 303 MB, about 0.241 ms at
// the 67 TFLOP/s of float32 outside the tensor cores (a 2e-4 tolerance on
// float32 inputs rules out TF32). So the products are register-tiled on
// the CUDA cores, and the rest is kept off their way.
//
// Design. Blocks run in parallel in no order, so the TPU's sequential
// chunk axis cannot be a grid axis here. The work splits the way Mamba2's
// own SSD kernels split it, in three launches on the caller's stream:
//   1. ssd_scan_states: one block per (bh, chunk) forms the chunk's state
//      S = xdt^T (B o exp(cs_last - cs)) as if h_prev were 0, and
//      exp(cs_last);
//   2. ssd_scan_pass: one thread per (bh, p, n) walks the chunks in order,
//      h = h * exp(cs_last) + S, leaving in place of each S the state the
//      chunk starts from (a read and a write of P x N floats a chunk);
//   3. ssd_scan_outputs: one block per (bh, chunk, 64-row tile of the
//      chunk) forms its rows of y from the state its chunk starts from.
// An earlier single pass handed the state from chunk to chunk between
// blocks; at the kernel-bench shape, that chain of 32 links was a large
// share of its time on an H100. The Q x Q matrix is never
// formed: a row tile takes the column tiles j <= i, 64 at a time, as a
// 64 x 64 tile G = C_i B_j^T o L (its transpose, so that each product reads
// 16-byte rows of shared memory), then y_i += G xdt_j. Every product gives
// each of 256 threads a 4 x 4 (or 4 x 8, 8 x 8) tile of outputs in
// registers, fed by 16-byte loads that a warp's lanes share or read as
// consecutive words, so each shared-memory load serves 16-32 FMAs. L is
// masked before the exp: for j > i, cs_i - cs_j > 0 and its exp can
// overflow, and inf * 0 is NaN. Ragged edges (P = 50, Q down to 16, N down
// to 8) are masked in the loads (zeros) and the stores, not padded. The
// cumulative sum of da is a block scan (four steps a thread, then warp and
// block sums); it starts anew in every chunk and sums in another order than
// the reference's, within float32 rounding.
//
// Build (what kernels/_lib.py runs):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xptxas -v
//        -shared -Xcompiler -fPIC -o libssd_scan.so ssd_scan.cu
//
// The entry point launches on the caller's stream, allocates nothing
// (the wrapper passes the state scratch), does not synchronise, and
// returns the CUDA error of the launches.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TQ = 64;                 // rows (and columns) of a chunk tile
constexpr int MAX_N = 128;
constexpr int MAX_P = 128;
constexpr int MAX_Q = 1024;

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

__host__ __device__ constexpr int pad4(int x) { return (x + 3) & ~3; }

// cs[i] = da[0] + ... + da[i] for i < n (n <= MAX_Q), by the block: four
// consecutive steps a thread, then a warp scan of the threads' sums and
// the sums of the warps before. Ends with the block synchronised.
template <typename T>
__device__ void chunk_cumsum(const T *__restrict__ da, float *cs, int n,
                             float *warp_sums) {
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    float v[4], run = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; k++) {
        const int i = 4 * tid + k;
        run += i < n ? to_f32(da[i]) : 0.0f;
        v[k] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
        const float up = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += up;
    }
    if (lane == 31) warp_sums[warp] = incl;
    float base = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) base = 0.0f;
    __syncthreads();
    for (int w = 0; w < warp; w++) base += warp_sums[w];
#pragma unroll
    for (int k = 0; k < 4; k++)
        if (4 * tid + k < n) cs[4 * tid + k] = base + v[k];
    __syncthreads();
}

// Four consecutive values as floats: one 16-byte (float) or 8-byte (bf16)
// load.
__device__ __forceinline__ float4 ld4(const float *p) {
    return *reinterpret_cast<const float4 *>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16 *p) {
    const uint2 u = *reinterpret_cast<const uint2 *>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162 *>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162 *>(&u.y));
    return make_float4(a.x, a.y, b.x, b.y);
}

// dst[k * drows + r] = m[r * ld + k] for r < drows, k < kn, zeros for rows
// r >= rv: a transposed tile, written along its rows (consecutive threads,
// consecutive words); read four k at a time when `vec` (kn % 4 == 0 and
// m's rows aligned for ld4).
template <typename T>
__device__ void tile_t(float *dst, int drows, const T *__restrict__ m, int ld,
                       int kn, int rv, bool vec) {
    if (vec) {
        for (int e = threadIdx.x; e < drows * (kn / 4); e += THREADS) {
            const int r = e % drows, k = 4 * (e / drows);
            const float4 v = r < rv ? ld4(m + (int64_t)r * ld + k)
                                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            dst[k * drows + r] = v.x;
            dst[(k + 1) * drows + r] = v.y;
            dst[(k + 2) * drows + r] = v.z;
            dst[(k + 3) * drows + r] = v.w;
        }
    } else {
        for (int e = threadIdx.x; e < drows * kn; e += THREADS) {
            const int r = e % drows, k = e / drows;
            dst[k * drows + r] = r < rv ? to_f32(m[(int64_t)r * ld + k]) : 0.0f;
        }
    }
}

// dst[r * dld + c] = m[r * ld + c] * w[r] (w null: 1) for r < TQ, c < dld,
// zeros for rows r >= rv and columns c >= cn; four columns at a time when
// `vec` (cn % 4 == 0 and m's rows aligned for ld4).
template <typename T>
__device__ void tile_n(float *dst, int dld, const T *__restrict__ m, int ld,
                       int cn, int rv, const float *w, bool vec) {
    if (vec) {
        for (int e = threadIdx.x; e < TQ * (dld / 4); e += THREADS) {
            const int r = e / (dld / 4), c = 4 * (e % (dld / 4));
            float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            if (r < rv && c < cn) {
                v = ld4(m + (int64_t)r * ld + c);
                if (w) {
                    const float x = w[r];
                    v.x *= x;
                    v.y *= x;
                    v.z *= x;
                    v.w *= x;
                }
            }
            *reinterpret_cast<float4 *>(dst + r * dld + c) = v;
        }
    } else {
        for (int e = threadIdx.x; e < TQ * dld; e += THREADS) {
            const int r = e / dld, c = e % dld;
            dst[e] = r < rv && c < cn
                         ? to_f32(m[(int64_t)r * ld + c]) * (w ? w[r] : 1.0f)
                         : 0.0f;
        }
    }
}

// acc[a][b] += x[a] * y[b] over the thread's rows a and columns b.
template <int R, int C>
__device__ __forceinline__ void outer(float (&acc)[R][C], const float (&x)[R],
                                      const float (&y)[C]) {
#pragma unroll
    for (int a = 0; a < R; a++)
#pragma unroll
        for (int b = 0; b < C; b++) acc[a][b] += x[a] * y[b];
}

// Row `at` of a shared tile, 4 * G values at columns c0 + 64 g + (0..3):
// one 16-byte load per group of 4.
template <int G>
__device__ __forceinline__ void row4(const float *row, int c0, float (&v)[4 * G]) {
#pragma unroll
    for (int g = 0; g < G; g++) {
        const float4 f = *reinterpret_cast<const float4 *>(row + c0 + 64 * g);
        v[4 * g] = f.x;
        v[4 * g + 1] = f.y;
        v[4 * g + 2] = f.z;
        v[4 * g + 3] = f.w;
    }
}

}  // namespace

// 1. The chunk's state as if h_prev were 0, S = xdt^T (B o w) with
// w = exp(cs_last - cs), into states[(bh, chunk)] (P x N), and
// exp(cs_last) into decay[(bh, chunk)]. Thread (tp, tn) of 16 x 16 holds
// rows tp*4 + 64 g (g < GP) and columns tn*4 + 64 g (g < GN) of S.
template <typename T, int GP, int GN>
__global__ void __launch_bounds__(THREADS)
ssd_scan_states(const T *__restrict__ xdt, const T *__restrict__ da,
                const T *__restrict__ b, float *__restrict__ states,
                float *__restrict__ decay, int s, int p, int n, int q,
                bool vec_p, bool vec_n) {
    extern __shared__ float4 smem4[];
    float *smem = reinterpret_cast<float *>(smem4);
    __shared__ float warp_sums[THREADS / 32];
    // Rows of the tiles span the threads' columns, zeros past p and n.
    constexpr int pp = 64 * GP, np = 64 * GN;
    float *cs = smem;                        // [q] cumsum of da, then w
    float *xs = cs + pad4(q);                // [TQ][pp] xdt rows
    float *bs = xs + TQ * pp;                // [TQ][np] B rows times w
    const int nc = s / q;
    const int64_t blk = blockIdx.x;          // bh * nc + chunk
    const int64_t bh = blk / nc;
    const int64_t t0 = (blk % nc) * q;
    const T *xb = xdt + (bh * s + t0) * p;
    const T *bb = b + (bh * s + t0) * n;
    const int tid = threadIdx.x, tp = tid / 16, tn = tid % 16;

    chunk_cumsum(da + bh * s + t0, cs, q, warp_sums);
    const float cs_last = cs[q - 1];
    __syncthreads();                         // every thread has cs_last
    for (int i = tid; i < q; i += THREADS) cs[i] = expf(cs_last - cs[i]);
    if (tid == 0) decay[blk] = expf(cs_last);

    float acc[4 * GP][4 * GN] = {};
    for (int j0 = 0; j0 < q; j0 += TQ) {
        __syncthreads();                     // w written; last tile consumed
        tile_n(xs, pp, xb + (int64_t)j0 * p, p, p, q - j0, nullptr, vec_p);
        tile_n(bs, np, bb + (int64_t)j0 * n, n, n, q - j0, cs + j0, vec_n);
        __syncthreads();
        const int rows = q - j0 < TQ ? q - j0 : TQ;
        for (int r = 0; r < rows; r++) {
            float xv[4 * GP], bv[4 * GN];
            row4<GP>(xs + r * pp, 4 * tp, xv);
            row4<GN>(bs + r * np, 4 * tn, bv);
            outer(acc, xv, bv);
        }
    }
    float *out = states + blk * p * n;
#pragma unroll
    for (int a = 0; a < 4 * GP; a++) {
        const int pi = 4 * tp + 64 * (a / 4) + a % 4;
#pragma unroll
        for (int c = 0; c < 4 * GN; c++) {
            const int ni = 4 * tn + 64 * (c / 4) + c % 4;
            if (pi < p && ni < n) out[pi * n + ni] = acc[a][c];
        }
    }
}

// 2. For each (bh, p, n) in order over the chunks: the state the chunk
// starts from replaces the chunk's S, and h = h * exp(cs_last) + S.
__global__ void __launch_bounds__(THREADS)
ssd_scan_pass(float *__restrict__ states, const float *__restrict__ decay,
              int64_t bh_count, int nc, int64_t pn) {
    const int64_t e = (int64_t)blockIdx.x * THREADS + threadIdx.x;
    if (e >= bh_count * pn) return;
    const int64_t bh = e / pn, k = e % pn;
    // Eight chunks' loads in flight at once: each thread's walk is a
    // chain of dependent steps, and nothing else hides their latency.
    constexpr int B = 8;
    float *at = states + bh * nc * pn + k;
    const float *dc = decay + bh * nc;
    float h = 0.0f;
    for (int c0 = 0; c0 < nc; c0 += B) {
        float sv[B], dv[B];
#pragma unroll
        for (int j = 0; j < B; j++)
            if (c0 + j < nc) {
                sv[j] = at[(c0 + j) * pn];
                dv[j] = dc[c0 + j];
            }
#pragma unroll
        for (int j = 0; j < B; j++)
            if (c0 + j < nc) {
                at[(c0 + j) * pn] = h;
                h = h * dv[j] + sv[j];
            }
    }
}

// 3. Rows [i0, i0 + 64) of a chunk's y: (C o exp(cs)) h_prev^T, then for
// each column tile j0 <= i0 the tile G^T = (C_i B_j^T o L)^T in shared
// memory and y += G xdt_j. Thread (ty, tx) of 16 x 16 holds rows ty*4..+3
// of y and its columns tx*4 + 64 g (g < GP); of G^T, rows (j) ty*4..+3 and
// columns (i) tx*4..+3.
template <typename T, int GP>
__global__ void __launch_bounds__(THREADS)
ssd_scan_outputs(const T *__restrict__ xdt, const T *__restrict__ da,
                 const T *__restrict__ b, const T *__restrict__ c,
                 const float *__restrict__ states, T *__restrict__ y, int s,
                 int p, int n, int q, bool vec_p, bool vec_n) {
    extern __shared__ float4 smem4[];
    float *smem = reinterpret_cast<float *>(smem4);
    __shared__ float warp_sums[THREADS / 32];
    constexpr int pp = 64 * GP;              // xs, hs rows: zeros past p
    const int nt = (q + TQ - 1) / TQ;
    const int nc = s / q;
    // The row tiles with the most column tiles go first.
    const int64_t chunks = (int64_t)gridDim.x / nt;
    const int64_t blk = blockIdx.x % chunks;     // bh * nc + chunk
    const int it = nt - 1 - (int)(blockIdx.x / chunks);
    const int64_t bh = blk / nc;
    const int64_t t0 = (blk % nc) * q;
    const int i0 = it * TQ;
    const int rows_end = q - i0 < TQ ? q : i0 + TQ;
    float *cs = smem;                        // [rows_end] cumsum of da
    float *ct = cs + pad4(q);                // [n][TQ] C rows i, transposed
    float *gt = ct + n * TQ;                 // [TQ][TQ] G^T
    float *bt = gt + TQ * TQ;                // [n][TQ] B rows j, transposed
    float *xs = bt + n * TQ;                 // [TQ][pp] xdt rows j
    float *hs = bt;                          // [n][pp] h_prev^T (first)
    const T *xb = xdt + (bh * s + t0) * p;
    const T *bb = b + (bh * s + t0) * n;
    const T *cb = c + (bh * s + t0) * n;
    const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

    // Transposed tiles are written along their rows (consecutive threads,
    // consecutive words) and read from global memory down its columns,
    // which L1 serves after the first touch of each line.
    chunk_cumsum(da + bh * s + t0, cs, rows_end, warp_sums);
    tile_t(ct, TQ, cb + (int64_t)i0 * n, n, n, q - i0, vec_n);
    tile_t(hs, pp, states + blk * p * n, n, n, p, n % 4 == 0);
    __syncthreads();

    // (C o exp(cs)) h_prev^T
    float acc[4][4 * GP] = {};
    for (int k = 0; k < n; k++) {
        float cv[4], hv[4 * GP];
        row4<1>(ct + k * TQ, 4 * ty, cv);
        row4<GP>(hs + k * pp, 4 * tx, hv);
        outer(acc, cv, hv);
    }
#pragma unroll
    for (int a = 0; a < 4; a++) {
        const int i = i0 + 4 * ty + a;
        const float e_cs = i < q ? expf(cs[i]) : 0.0f;
#pragma unroll
        for (int g = 0; g < 4 * GP; g++) acc[a][g] *= e_cs;
    }

    for (int j0 = 0; j0 <= i0; j0 += TQ) {
        __syncthreads();                     // hs, bt, xs, gt consumed
        tile_t(bt, TQ, bb + (int64_t)j0 * n, n, n, q - j0, vec_n);
        tile_n(xs, pp, xb + (int64_t)j0 * p, p, p, q - j0, nullptr, vec_p);
        __syncthreads();
        // G^T tile: rows j = j0 + 4ty + a, columns i = i0 + 4tx + d.
        float g[4][4] = {};
        for (int k = 0; k < n; k++) {
            float bv[4], cv[4];
            row4<1>(bt + k * TQ, 4 * ty, bv);
            row4<1>(ct + k * TQ, 4 * tx, cv);
            outer(g, bv, cv);
        }
#pragma unroll
        for (int a = 0; a < 4; a++) {
            const int j = j0 + 4 * ty + a;
            float4 out;
            float *o = &out.x;
#pragma unroll
            for (int d = 0; d < 4; d++) {
                const int i = i0 + 4 * tx + d;
                o[d] = j <= i && i < q ? g[a][d] * expf(cs[i] - cs[j]) : 0.0f;
            }
            *reinterpret_cast<float4 *>(gt + (4 * ty + a) * TQ + 4 * tx) = out;
        }
        __syncthreads();
        // y_i += G xdt_j
        const int cols = q - j0 < TQ ? q - j0 : TQ;
        for (int jj = 0; jj < cols; jj++) {
            float gv[4], xv[4 * GP];
            row4<1>(gt + jj * TQ, 4 * ty, gv);
            row4<GP>(xs + jj * pp, 4 * tx, xv);
            outer(acc, gv, xv);
        }
    }
    T *yb = y + (bh * s + t0) * p;
#pragma unroll
    for (int a = 0; a < 4; a++) {
        const int i = i0 + 4 * ty + a;
#pragma unroll
        for (int g = 0; g < 4 * GP; g++) {
            const int pi = 4 * tx + 64 * (g / 4) + g % 4;
            if (i < q && pi < p) yb[(int64_t)i * p + pi] = from_f32<T>(acc[a][g]);
        }
    }
}

namespace {

size_t states_smem(int q, int gp, int gn) {
    return sizeof(float) * (pad4(q) + (size_t)TQ * 64 * (gp + gn));
}

size_t outputs_smem(int q, int n, int gp) {
    const size_t tail = (size_t)n * TQ + (size_t)TQ * 64 * gp;   // bt, xs
    const size_t hs = (size_t)n * 64 * gp;
    return sizeof(float) * (pad4(q) + (size_t)n * TQ + (size_t)TQ * TQ +
                            (tail > hs ? tail : hs));
}

template <typename Kern>
cudaError_t allow_smem(Kern kernel, size_t bytes) {
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bytes);
}

// Whether ld4 may read rows of `cols` values of T at `ptr`.
template <typename T>
bool vec_ok(const void *ptr, int cols) {
    return cols % 4 == 0 && (uintptr_t)ptr % (4 * sizeof(T)) == 0;
}

template <typename T, int GP, int GN>
int launch(const void *xdt, const void *da, const void *b, const void *c,
           void *y, void *states, void *decay, int bh, int s, int p, int n,
           int q, cudaStream_t st) {
    const bool vec_p = vec_ok<T>(xdt, p);
    const bool vec_n = vec_ok<T>(b, n) && vec_ok<T>(c, n);
    const int nc = s / q, nt = (q + TQ - 1) / TQ;
    const int64_t chunks = (int64_t)bh * nc, pn = (int64_t)p * n;
    const size_t smem1 = states_smem(q, GP, GN), smem3 = outputs_smem(q, n, GP);
    auto k1 = ssd_scan_states<T, GP, GN>;
    auto k3 = ssd_scan_outputs<T, GP>;
    cudaError_t err = allow_smem(k1, smem1);
    if (err == cudaSuccess) err = allow_smem(k3, smem3);
    if (err != cudaSuccess) return (int)err;
    k1<<<(unsigned)chunks, THREADS, smem1, st>>>(
        (const T *)xdt, (const T *)da, (const T *)b, (float *)states,
        (float *)decay, s, p, n, q, vec_p, vec_n);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    ssd_scan_pass<<<(unsigned)((bh * pn + THREADS - 1) / THREADS), THREADS,
                    0, st>>>((float *)states, (const float *)decay, bh, nc,
                             pn);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    k3<<<(unsigned)(chunks * nt), THREADS, smem3, st>>>(
        (const T *)xdt, (const T *)da, (const T *)b, (const T *)c,
        (const float *)states, (T *)y, s, p, n, q, vec_p, vec_n);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_dtype(const void *xdt, const void *da, const void *b,
                 const void *c, void *y, void *states, void *decay, int bh,
                 int s, int p, int n, int q, cudaStream_t st) {
    if (p <= 64 && n <= 64)
        return launch<T, 1, 1>(xdt, da, b, c, y, states, decay, bh, s, p, n,
                               q, st);
    if (p <= 64)
        return launch<T, 1, 2>(xdt, da, b, c, y, states, decay, bh, s, p, n,
                               q, st);
    if (n <= 64)
        return launch<T, 2, 1>(xdt, da, b, c, y, states, decay, bh, s, p, n,
                               q, st);
    return launch<T, 2, 2>(xdt, da, b, c, y, states, decay, bh, s, p, n, q,
                           st);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (xdt, da, b, c and y share it). states:
// bh * s/q * p * n floats; decay: bh * s/q floats (both scratch).
extern "C" int ssd_scan_launch(const void *xdt, const void *da,
                               const void *b, const void *c, void *y,
                               void *states, void *decay, int bh, int s,
                               int p, int n, int q, int dtype,
                               void *stream) {
    if (bh <= 0 || s <= 0 || p <= 0 || p > MAX_P || n <= 0 || n > MAX_N ||
        q <= 0 || q > MAX_Q || s % q != 0 ||
        (int64_t)bh * (s / q) * ((q + TQ - 1) / TQ) > 0x7fffffff)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (dtype == 0)
        return launch_dtype<float>(xdt, da, b, c, y, states, decay, bh, s, p,
                                   n, q, st);
    if (dtype == 1)
        return launch_dtype<__nv_bfloat16>(xdt, da, b, c, y, states, decay,
                                           bh, s, p, n, q, st);
    return (int)cudaErrorInvalidValue;
}

extern "C" const char *kernel_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
