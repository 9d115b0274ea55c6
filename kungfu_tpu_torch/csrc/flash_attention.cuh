// Shared pieces of the flash-attention kernels for Hopper (sm_90a): tile
// geometry and type conversions for all three; for the simple design of the
// dQ kernel, shared-memory carving, synchronous tile loads, a warp sum and
// one 16x16 tensor-core product (WMMA, bf16/fp16 in, f32 accumulate).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace kf_flash {

using namespace nvcuda;

constexpr int BM = 64;        // query rows per tile
constexpr int BN = 64;        // key rows per tile
constexpr int NWARPS = 4;     // dQ: each warp owns 16 rows of a 64-row tile
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG_INF = -1e30f;  // the JAX kernel's mask value
constexpr int PAD16 = 8;  // 16-bit rows padded by 16 bytes (bank spread)
constexpr int PADF = 4;   // f32 rows padded by 16 bytes

template <int HD> struct Ld {
  static constexpr int T16 = HD + PAD16;  // q/k/v/dO tile row stride
  static constexpr int ACC = HD + PADF;   // f32 accumulator row stride
  static constexpr int S = BN + PADF;     // f32 score row stride
  static constexpr int P = BN + PAD16;    // 16-bit probability row stride
};

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f(__half x) {
  return __half2float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ __nv_bfloat16 from_f(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f(float x) {
  return __float2half(x);
}

// Cuts a dynamic shared-memory block into 128-byte aligned arrays. The
// same code runs on the host (base 0) to size the block for the launch.
struct Carve {
  uintptr_t base;
  size_t off;
  template <typename U> __host__ __device__ U* take(size_t n) {
    off = (off + 127) & ~size_t(127);
    U* p = reinterpret_cast<U*>(base + off);
    off += n * sizeof(U);
    return p;
  }
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Copy rows [row0, row0 + ROWS) of a row-major (S, HD) matrix into shared
// memory (row stride HD + PAD16) in 16-byte pieces; rows >= S become zero,
// which is how the ragged tail of an uneven S is masked on load.
template <typename T, int ROWS, int HD>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src,
                                          int row0, int S) {
  constexpr int CH = HD * (int)sizeof(T) / 16;
  constexpr int EPC = 16 / (int)sizeof(T);
  for (int i = threadIdx.x; i < ROWS * CH; i += NTHREADS) {
    const int r = i / CH, c = i % CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * HD + c * EPC);
    *reinterpret_cast<uint4*>(dst + r * Ld<HD>::T16 + c * EPC) = val;
  }
}

// One warp: C(16x16, f32, row-major, ldc) = [C +] A(16xK) @ B(Kx16).
// A is row-major (a[m*lda+k]) or col-major (a[k*lda+m]); B is row-major
// (b[k*ldb+n]) or col-major (b[n*ldb+k]). All pointers 32-byte aligned.
template <typename T, typename LA, typename LB, int K>
__device__ __forceinline__ void mma16(float* c, int ldc, const T* a, int lda,
                                      const T* b, int ldb, bool accumulate) {
  wmma::fragment<wmma::matrix_a, 16, 16, 16, T, LA> fa;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, T, LB> fb;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> fc;
  if (accumulate)
    wmma::load_matrix_sync(fc, c, ldc, wmma::mem_row_major);
  else
    wmma::fill_fragment(fc, 0.0f);
#pragma unroll
  for (int kk = 0; kk < K; kk += 16) {
    const T* ap;
    const T* bp;
    if constexpr (std::is_same<LA, wmma::row_major>::value) ap = a + kk;
    else ap = a + kk * lda;
    if constexpr (std::is_same<LB, wmma::row_major>::value) bp = b + kk * ldb;
    else bp = b + kk;
    wmma::load_matrix_sync(fa, ap, lda);
    wmma::load_matrix_sync(fb, bp, ldb);
    wmma::mma_sync(fc, fa, fb, fc);
  }
  wmma::store_matrix_sync(c, fc, ldc, wmma::mem_row_major);
}

}  // namespace kf_flash
