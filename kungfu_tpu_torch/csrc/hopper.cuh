// Hopper (sm_90a) building blocks of the flash-attention kernels: mbarriers
// and named barriers, TMA tile loads through a 3-D tensor map, wgmma
// shared-memory descriptors for 128-byte swizzled tiles, and the m64n64k16
// warpgroup product with A from shared memory (SS) or from registers (RS).
//
// Tile convention: a 64-row tile of 16-bit values with a row of 64 elements
// (128 bytes) is one TMA box with CU_TENSOR_MAP_SWIZZLE_128B, 8 KB, based at
// a 1024-byte boundary. A row of 128 elements is two such boxes ("halves")
// one after the other.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; libcuda itself is not linked
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace kf_hopper {

constexpr int BOX = 64;               // rows and 16-bit columns of one TMA box
constexpr int BOX_BYTES = BOX * 128;  // 8 KB
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// 2^x by the SFU, flushing denormal results to zero.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Barrier `id` (1-15; 0 is __syncthreads) among the first `n` threads of the
// block, so that a consumer warpgroup can wait for itself alone.
__device__ __forceinline__ void named_bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// ---- mbarrier -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// One arrival that also announces `bytes` of TMA traffic for this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA ------------------------------------------------------------------

// One box of a (cols, rows, batch) tensor map into shared memory; rows past
// the tensor's end arrive as zeros. Completion is counted on `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int col, int row,
                                            int batch) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(row),
      "r"(batch)
      : "memory");
}

// ---- wgmma ----------------------------------------------------------------

// Descriptor of a 128-byte swizzled shared-memory operand. K-major (the
// reduction dimension contiguous): step k by +32 bytes inside the 128-byte
// row, SBO = 1024 (8 rows). MN-major: step k by +16 rows (2048 bytes), SBO =
// 1024 (8 k-rows), LBO = stride between 64-element column blocks.
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  const uint32_t a = smem_u32(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint64_t desc_k(const void* p) { return desc_sw128(p, 16, 1024); }
__device__ __forceinline__ uint64_t desc_mn(const void* p) {
  return desc_sw128(p, BOX_BYTES, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across an asynchronous wgmma, from its launch to its wait.
template <int N> __device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define KF_D32                                                                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "   \
  "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define KF_ACC32(d)                                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),        \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),  \
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),           \
      "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),           \
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),           \
      "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// D(64x64 f32) = [D +] A(64x16, smem, K-major) * B(16x64, smem, K-major).
#define KF_WGMMA_SS(TY)                                                        \
  asm volatile(                                                                \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                             \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " KF_D32       \
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"                                        \
      : KF_ACC32(d)                                                            \
      : "l"(da), "l"(db), "r"(scale_d))
template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int scale_d) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) KF_WGMMA_SS("bf16");
  else KF_WGMMA_SS("f16");
}

// D(64x64 f32) += A(64x16, registers) * B(16x64, smem, MN-major).
#define KF_WGMMA_RS(TY)                                                        \
  asm volatile(                                                                \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                             \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " KF_D32       \
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                          \
      : KF_ACC32(d)                                                            \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d))
template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) KF_WGMMA_RS("bf16");
  else KF_WGMMA_RS("f16");
}

template <typename T> __device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <> __device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}
template <> __device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 h = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The inverse of pack2: two 16-bit values of one 32-bit word as floats.
template <typename T> __device__ __forceinline__ float2 unpack2(uint32_t u);
template <> __device__ __forceinline__ float2 unpack2<__nv_bfloat16>(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}
template <> __device__ __forceinline__ float2 unpack2<__half>(uint32_t u) {
  return __half22float2(*reinterpret_cast<const __half2*>(&u));
}

// The m64n64 accumulator of one thread (lane = 4g + t of warp w) holds row
// 16w + g + 8*((i/2)%2), column 8*(i/4) + 2t + i%2 in d[i]. Columns
// [16kk, 16kk + 16) of it are, rounded to 16 bits, exactly the register A
// fragment of the k-step kk of a following wgmma.
template <typename T>
__device__ __forceinline__ void acc_to_a(const float (&d)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[kk][j] = pack2<T>(d[8 * kk + 2 * j], d[8 * kk + 2 * j + 1]);
}

__device__ __forceinline__ int acc_row(int i) { return 8 * ((i / 2) % 2); }
__device__ __forceinline__ int acc_col(int i) { return 8 * (i / 4) + (i % 2); }

// ---- host: tensor maps without linking libcuda ----------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A function of libcuda by name, or nullptr, found through the runtime.
inline void* libcuda_fn(const char* name) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
  cudaError_t e = cudaGetDriverEntryPointByVersion(name, &p, 12000, cudaEnableDefault, &q);
#else
  cudaError_t e = cudaGetDriverEntryPoint(name, &p, cudaEnableDefault, &q);
#endif
  return e == cudaSuccess && q == cudaDriverEntryPointSuccess ? p : nullptr;
}

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) fn = (EncodeTiledFn)libcuda_fn("cuTensorMapEncodeTiled");
  return fn;
}

// Makes the device that holds `ptr` current on this host thread if the thread
// has no current context. A thread that has not used CUDA yet (autograd's
// backward thread, say) has none, and cuTensorMapEncodeTiled refuses to
// encode without one. The check is a thread-local read in libcuda.
inline cudaError_t bind_device_of(const void* ptr) {
  typedef CUresult (*CtxGetCurrentFn)(CUcontext*);
  static CtxGetCurrentFn current = (CtxGetCurrentFn)libcuda_fn("cuCtxGetCurrent");
  CUcontext ctx = nullptr;
  if (current != nullptr && current(&ctx) == CUDA_SUCCESS && ctx != nullptr)
    return cudaSuccess;
  cudaPointerAttributes a;
  cudaError_t e = cudaPointerGetAttributes(&a, ptr);
  return e != cudaSuccess ? e : cudaSetDevice(a.device);
}

// Tensor map of a contiguous (BH, S, HD) 16-bit tensor as (HD, S, BH) with
// 64 x 64 boxes, 128-byte swizzle and zero fill past S.
template <typename T>
cudaError_t make_map(CUtensorMap* map, const void* ptr, int BH, int S, int HD) {
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)HD, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)HD * sizeof(T),
                                 (cuuint64_t)S * HD * sizeof(T)};
  const cuuint32_t box[3] = {BOX, BOX, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUtensorMapDataType dt = std::is_same<T, __half>::value
                                     ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUresult r = enc(map, dt, 3, const_cast<void*>(ptr), dims, strides, box, estr,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace kf_hopper
