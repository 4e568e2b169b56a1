// K3 on Hopper: the SW+ row gather, out[j] = x[row_src[j]] if
// row_valid[j] else 0, for j < t_pad.
//
// Replaces src/repro/kernels/coalesced_gather.py::_gather_kernel (the
// Pallas kernel behind gather_rows). There, the whole of x sits in VMEM
// and each grid step copies BM rows with a fori_loop; the ops layer falls
// back to an XLA gather when x exceeds an 8 MiB VMEM budget. Here rows
// are read straight from device memory, so there is no budget and no
// fallback: the wrapper launches this kernel at every size.
//
// Bound on this card: bytes. It does no arithmetic; it reads each valid
// row and writes every output row once (at the decode shape 33.5 MB
// written, about 0.010 ms at 3.35 TB/s). Design: one CUDA block per
// destination row (grid-stride over rows), which loads its own row_src and
// row_valid entries (the TPU kernel's scalar prefetch); its threads move
// the row in 16-byte words, neighbouring threads on neighbouring
// addresses, so every warp issues full 512-byte transactions. The copy is
// of bytes, so the result equals the plain version bit for bit, for any
// dtype. Narrower words (8/4/2/1 bytes) serve rows whose size or
// alignment is not a multiple of 16.
//
// Build (what kernels/_lib.py runs):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xptxas -v
//        -shared -Xcompiler -fPIC -o libcoalesced_gather.so coalesced_gather.cu
//
// The entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() of the launch.
#include <cuda_runtime.h>
#include <stdint.h>

template <typename V> __device__ __forceinline__ V zero_word();
template <> __device__ __forceinline__ uint4 zero_word<uint4>() {
    return make_uint4(0u, 0u, 0u, 0u);
}
template <> __device__ __forceinline__ uint2 zero_word<uint2>() {
    return make_uint2(0u, 0u);
}
template <> __device__ __forceinline__ uint32_t zero_word<uint32_t>() {
    return 0u;
}
template <> __device__ __forceinline__ uint16_t zero_word<uint16_t>() {
    return 0;
}
template <> __device__ __forceinline__ uint8_t zero_word<uint8_t>() {
    return 0;
}

// x: (t, n_words) words; out: (t_pad, n_words). row_src is clamped into
// [0, t) as the reference's gather clamps it.
template <typename V>
__global__ void gather_rows_kernel(const V *__restrict__ x,
                                   const int32_t *__restrict__ row_src,
                                   const int32_t *__restrict__ row_valid,
                                   V *__restrict__ out, int64_t t,
                                   int64_t n_words, int64_t t_pad) {
    for (int64_t j = blockIdx.x; j < t_pad; j += gridDim.x) {
        V *dst = out + j * n_words;
        if (row_valid[j] > 0 && t > 0) {
            int64_t src = row_src[j];
            src = src < 0 ? 0 : (src >= t ? t - 1 : src);
            const V *s = x + src * n_words;
            for (int64_t i = threadIdx.x; i < n_words; i += blockDim.x)
                dst[i] = s[i];
        } else {
            const V z = zero_word<V>();
            for (int64_t i = threadIdx.x; i < n_words; i += blockDim.x)
                dst[i] = z;
        }
    }
}

template <typename V>
static int launch(const void *x, const void *row_src, const void *row_valid,
                  void *out, int64_t t, int64_t row_bytes, int64_t t_pad,
                  cudaStream_t stream) {
    const int64_t n_words = row_bytes / (int64_t)sizeof(V);
    int64_t threads = ((n_words + 31) / 32) * 32;
    if (threads < 32) threads = 32;
    if (threads > 256) threads = 256;
    int64_t grid = t_pad < (1 << 20) ? t_pad : (1 << 20);
    if (grid < 1) return (int)cudaGetLastError();
    gather_rows_kernel<V><<<(unsigned)grid, (unsigned)threads, 0, stream>>>(
        (const V *)x, (const int32_t *)row_src, (const int32_t *)row_valid,
        (V *)out, t, n_words, t_pad);
    return (int)cudaGetLastError();
}

// word_bytes: 16, 8, 4, 2 or 1; row_bytes and both row bases must be
// multiples of it (the wrapper picks the widest that fits).
extern "C" int gather_rows_launch(const void *x, const void *row_src,
                                  const void *row_valid, void *out,
                                  int64_t t, int64_t row_bytes,
                                  int64_t t_pad, int word_bytes,
                                  void *stream) {
    cudaStream_t s = (cudaStream_t)stream;
    switch (word_bytes) {
    case 16: return launch<uint4>(x, row_src, row_valid, out, t, row_bytes,
                                  t_pad, s);
    case 8: return launch<uint2>(x, row_src, row_valid, out, t, row_bytes,
                                 t_pad, s);
    case 4: return launch<uint32_t>(x, row_src, row_valid, out, t,
                                    row_bytes, t_pad, s);
    case 2: return launch<uint16_t>(x, row_src, row_valid, out, t,
                                    row_bytes, t_pad, s);
    case 1: return launch<uint8_t>(x, row_src, row_valid, out, t, row_bytes,
                                   t_pad, s);
    default: return (int)cudaErrorInvalidValue;
    }
}

extern "C" const char *kernel_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
