// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV kernels behind
// a plain C interface (loaded with ctypes by kungfu_tpu_torch/ops/_build.py).
//
// Replaces the three Pallas TPU kernels of kungfu_tpu/ops/flash_attention.py:
//   flash_fwd_kernel  <- _kernel      (pallas_call at :194, body :109-167)
//   flash_dq_kernel   <- _dq_kernel   (pallas_call at :368, body :228-272)
//   flash_dkv_kernel  <- _dkv_kernel  (pallas_call at :386, body :275-321)
//
// Layout: q, k, v, o, dO, dq, dk, dv are contiguous (B*H, S, hd) in bf16 or
// fp16; lse and delta are (B*H, S) f32 (the TPU kernels' 8-lane replication
// is a Mosaic layout constraint with no meaning here).
//
// Design (simple and right first). One block of 4 warps per (b*h, 64-row
// tile). The TPU grid's sequential last dimension, which carried m/l/acc and
// the dq/dk/dv sums in VMEM across grid steps, becomes a loop inside the
// block; the accumulators live in shared memory as f32. Products run on the
// tensor cores through WMMA (bf16/fp16 in, f32 accumulate) -- unlike the TPU
// kernels, which upcast q/k/v to f32 before every dot, so parity with the f32
// reference holds at bf16 tolerance. Causal loops are bounded at the live
// blocks (forward and dQ stop at the diagonal tile, dK/dV start at it),
// instead of the TPU's clamped fetch indices. An uneven S is masked inside
// the kernels (zero-filled rows on load, dead columns masked in the softmax)
// where the JAX package falls back to dense attention.
//
// What bounds it on the H100: at the BERT-base shape (B*H=96, S=512, hd=64,
// causal) each kernel moves ~25-38 MB and does 3-7 GFLOP, so the memory
// bound (~8-11 us at 3.35 TB/s) is above the tensor-core bound; the work per
// block is small enough that latency, not either roof, decides. What this
// design leaves on the table: scores, probabilities and accumulators make a
// round trip through shared memory on every tile (WMMA fragments have no
// documented row mapping, so the per-row softmax rescale reads them back);
// no cp.async/TMA pipelining of the next K/V tile; no wgmma; one 64-row tile
// per block with 4 warps, so one or two blocks per SM at hd=128.
#include "flash_attention.cuh"

namespace kf_flash {

template <typename T, int HD> struct FwdSmem {
  T *q, *k, *v, *p;
  float *s, *acc, *m, *l;
  size_t bytes;
  __host__ __device__ explicit FwdSmem(uintptr_t base) {
    Carve c{base, 0};
    q = c.take<T>(BM * Ld<HD>::T16);
    k = c.take<T>(BN * Ld<HD>::T16);
    v = c.take<T>(BN * Ld<HD>::T16);
    s = c.take<float>(BM * Ld<HD>::S);
    p = c.take<T>(BM * Ld<HD>::P);
    acc = c.take<float>(BM * Ld<HD>::ACC);
    m = c.take<float>(BM);
    l = c.take<float>(BM);
    bytes = c.off;
  }
};

// O = softmax(q k^T * scale [causal]) v, lse = m + log(l), by online softmax
// over the key tiles of one 64-row query tile.
template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int S, int causal, float scale) {
  extern __shared__ __align__(128) char smem_raw[];
  FwdSmem<T, HD> sm(reinterpret_cast<uintptr_t>(smem_raw));
  constexpr int LT = Ld<HD>::T16, LS = Ld<HD>::S, LP = Ld<HD>::P, LA = Ld<HD>::ACC;

  const int bh = blockIdx.y, q0 = blockIdx.x * BM;
  const size_t base = (size_t)bh * S * HD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, r0 = warp * 16;

  load_tile<T, BM, HD>(sm.q, q + base, q0, S);
  for (int i = threadIdx.x; i < BM * LA; i += NTHREADS) sm.acc[i] = 0.0f;
  for (int i = threadIdx.x; i < BM; i += NTHREADS) {
    sm.m[i] = NEG_INF;
    sm.l[i] = 0.0f;
  }
  const int n_all = (S + BN - 1) / BN;
  const int n_kt = causal ? min(n_all, (q0 + BM - 1) / BN + 1) : n_all;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<T, BN, HD>(sm.k, k + base, k0, S);
    load_tile<T, BN, HD>(sm.v, v + base, k0, S);
    __syncthreads();
    for (int j = 0; j < BN; j += 16)
      mma16<T, wmma::row_major, wmma::col_major, HD>(
          sm.s + r0 * LS + j, LS, sm.q + r0 * LT, LT, sm.k + j * LT, LT, false);
    __syncwarp();
    for (int rr = 0; rr < 16; ++rr) {
      const int r = r0 + rr, qpos = q0 + r;
      const float m_old = sm.m[r];
      float s[BN / 32];
      bool live[BN / 32];
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < BN / 32; ++c) {
        const int col = lane + 32 * c, kpos = k0 + col;
        live[c] = kpos < S && (!causal || kpos <= qpos);
        s[c] = live[c] ? sm.s[r * LS + col] * scale : NEG_INF;
        mx = fmaxf(mx, s[c]);
      }
      const float m_new = fmaxf(m_old, warp_max(mx));
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < BN / 32; ++c) {
        const float p = live[c] ? expf(s[c] - m_new) : 0.0f;
        sum += p;
        sm.p[r * LP + lane + 32 * c] = from_f<T>(p);
      }
      sum = warp_sum(sum);
      const float corr = expf(m_old - m_new);
      for (int d = lane; d < HD; d += 32) sm.acc[r * LA + d] *= corr;
      if (lane == 0) {
        sm.m[r] = m_new;
        sm.l[r] = sm.l[r] * corr + sum;
      }
    }
    __syncwarp();
    for (int j = 0; j < HD; j += 16)
      mma16<T, wmma::row_major, wmma::row_major, BN>(
          sm.acc + r0 * LA + j, LA, sm.p + r0 * LP, LP, sm.v + j, LT, true);
  }
  __syncwarp();
  for (int rr = 0; rr < 16; ++rr) {
    const int r = r0 + rr, qpos = q0 + r;
    if (qpos >= S) break;
    const float inv = 1.0f / sm.l[r];
    for (int d = lane; d < HD; d += 32)
      o[base + (size_t)qpos * HD + d] = from_f<T>(sm.acc[r * LA + d] * inv);
    if (lane == 0) lse[(size_t)bh * S + qpos] = sm.m[r] + logf(sm.l[r]);
  }
}

template <typename T, int HD> struct DqSmem {
  T *q, *dout, *k, *v, *ds;
  float *s, *dp, *acc, *lse, *delta;
  size_t bytes;
  __host__ __device__ explicit DqSmem(uintptr_t base) {
    Carve c{base, 0};
    q = c.take<T>(BM * Ld<HD>::T16);
    dout = c.take<T>(BM * Ld<HD>::T16);
    k = c.take<T>(BN * Ld<HD>::T16);
    v = c.take<T>(BN * Ld<HD>::T16);
    s = c.take<float>(BM * Ld<HD>::S);
    dp = c.take<float>(BM * Ld<HD>::S);
    ds = c.take<T>(BM * Ld<HD>::P);
    acc = c.take<float>(BM * Ld<HD>::ACC);
    lse = c.take<float>(BM);
    delta = c.take<float>(BM);
    bytes = c.off;
  }
};

// dq = sum_k ds k * scale with p = exp(q k^T * scale - lse),
// ds = p * (dO v^T - delta). delta = rowsum(dO * O) is computed here, once
// per query row, and written out for the dK/dV kernel (the JAX package
// leaves it to a separate XLA pass).
template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ o,
                const T* __restrict__ dout, const float* __restrict__ lse,
                T* __restrict__ dq, float* __restrict__ delta, int S,
                int causal, float scale) {
  extern __shared__ __align__(128) char smem_raw[];
  DqSmem<T, HD> sm(reinterpret_cast<uintptr_t>(smem_raw));
  constexpr int LT = Ld<HD>::T16, LS = Ld<HD>::S, LP = Ld<HD>::P, LA = Ld<HD>::ACC;

  const int bh = blockIdx.y, q0 = blockIdx.x * BM;
  const size_t base = (size_t)bh * S * HD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, r0 = warp * 16;

  load_tile<T, BM, HD>(sm.q, q + base, q0, S);
  load_tile<T, BM, HD>(sm.dout, dout + base, q0, S);
  for (int i = threadIdx.x; i < BM * LA; i += NTHREADS) sm.acc[i] = 0.0f;
  for (int rr = 0; rr < 16; ++rr) {
    const int r = r0 + rr, qpos = q0 + r;
    float dsum = 0.0f;
    if (qpos < S)
      for (int d = lane; d < HD; d += 32)
        dsum += to_f(dout[base + (size_t)qpos * HD + d]) *
                to_f(o[base + (size_t)qpos * HD + d]);
    dsum = warp_sum(dsum);
    if (lane == 0) {
      sm.delta[r] = dsum;
      sm.lse[r] = qpos < S ? lse[(size_t)bh * S + qpos] : 0.0f;
      if (qpos < S) delta[(size_t)bh * S + qpos] = dsum;
    }
  }
  const int n_all = (S + BN - 1) / BN;
  const int n_kt = causal ? min(n_all, (q0 + BM - 1) / BN + 1) : n_all;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();
    load_tile<T, BN, HD>(sm.k, k + base, k0, S);
    load_tile<T, BN, HD>(sm.v, v + base, k0, S);
    __syncthreads();
    for (int j = 0; j < BN; j += 16) {
      mma16<T, wmma::row_major, wmma::col_major, HD>(
          sm.s + r0 * LS + j, LS, sm.q + r0 * LT, LT, sm.k + j * LT, LT, false);
      mma16<T, wmma::row_major, wmma::col_major, HD>(
          sm.dp + r0 * LS + j, LS, sm.dout + r0 * LT, LT, sm.v + j * LT, LT, false);
    }
    __syncwarp();
    for (int rr = 0; rr < 16; ++rr) {
      const int r = r0 + rr, qpos = q0 + r;
#pragma unroll
      for (int c = 0; c < BN / 32; ++c) {
        const int col = lane + 32 * c, kpos = k0 + col;
        const bool live = qpos < S && kpos < S && (!causal || kpos <= qpos);
        const float p = live ? expf(sm.s[r * LS + col] * scale - sm.lse[r]) : 0.0f;
        sm.ds[r * LP + col] = from_f<T>(p * (sm.dp[r * LS + col] - sm.delta[r]));
      }
    }
    __syncwarp();
    for (int j = 0; j < HD; j += 16)
      mma16<T, wmma::row_major, wmma::row_major, BN>(
          sm.acc + r0 * LA + j, LA, sm.ds + r0 * LP, LP, sm.k + j, LT, true);
  }
  __syncwarp();
  for (int rr = 0; rr < 16; ++rr) {
    const int r = r0 + rr, qpos = q0 + r;
    if (qpos >= S) break;
    for (int d = lane; d < HD; d += 32)
      dq[base + (size_t)qpos * HD + d] = from_f<T>(sm.acc[r * LA + d] * scale);
  }
}

template <typename T, int HD> struct DkvSmem {
  T *k, *v, *q, *dout, *p, *ds;
  float *s, *dp, *dk, *dv, *lse, *delta;
  size_t bytes;
  __host__ __device__ explicit DkvSmem(uintptr_t base) {
    Carve c{base, 0};
    k = c.take<T>(BN * Ld<HD>::T16);
    v = c.take<T>(BN * Ld<HD>::T16);
    q = c.take<T>(BM * Ld<HD>::T16);
    dout = c.take<T>(BM * Ld<HD>::T16);
    s = c.take<float>(BM * Ld<HD>::S);
    dp = c.take<float>(BM * Ld<HD>::S);
    p = c.take<T>(BM * Ld<HD>::P);
    ds = c.take<T>(BM * Ld<HD>::P);
    dk = c.take<float>(BN * Ld<HD>::ACC);
    dv = c.take<float>(BN * Ld<HD>::ACC);
    lse = c.take<float>(BM);
    delta = c.take<float>(BM);
    bytes = c.off;
  }
};

// dv = sum_q p^T dO, dk = sum_q ds^T q * scale, for one 64-row key tile,
// looping over the live query tiles (causal: from the diagonal tile on).
template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 T* __restrict__ dk, T* __restrict__ dv, int S, int causal,
                 float scale) {
  extern __shared__ __align__(128) char smem_raw[];
  DkvSmem<T, HD> sm(reinterpret_cast<uintptr_t>(smem_raw));
  constexpr int LT = Ld<HD>::T16, LS = Ld<HD>::S, LP = Ld<HD>::P, LA = Ld<HD>::ACC;

  const int bh = blockIdx.y, k0 = blockIdx.x * BN;
  const size_t base = (size_t)bh * S * HD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, r0 = warp * 16;

  load_tile<T, BN, HD>(sm.k, k + base, k0, S);
  load_tile<T, BN, HD>(sm.v, v + base, k0, S);
  for (int i = threadIdx.x; i < BN * LA; i += NTHREADS) {
    sm.dk[i] = 0.0f;
    sm.dv[i] = 0.0f;
  }
  const int n_qt = (S + BM - 1) / BM;
  const int qt0 = causal ? k0 / BM : 0;

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * BM;
    __syncthreads();  // previous Q/dO/P/dS tiles fully consumed
    load_tile<T, BM, HD>(sm.q, q + base, q0, S);
    load_tile<T, BM, HD>(sm.dout, dout + base, q0, S);
    for (int i = threadIdx.x; i < BM; i += NTHREADS) {
      const bool in = q0 + i < S;
      sm.lse[i] = in ? lse[(size_t)bh * S + q0 + i] : 0.0f;
      sm.delta[i] = in ? delta[(size_t)bh * S + q0 + i] : 0.0f;
    }
    __syncthreads();
    // scores and dP for this warp's 16 query rows
    for (int j = 0; j < BN; j += 16) {
      mma16<T, wmma::row_major, wmma::col_major, HD>(
          sm.s + r0 * LS + j, LS, sm.q + r0 * LT, LT, sm.k + j * LT, LT, false);
      mma16<T, wmma::row_major, wmma::col_major, HD>(
          sm.dp + r0 * LS + j, LS, sm.dout + r0 * LT, LT, sm.v + j * LT, LT, false);
    }
    __syncwarp();
    for (int rr = 0; rr < 16; ++rr) {
      const int r = r0 + rr, qpos = q0 + r;
#pragma unroll
      for (int c = 0; c < BN / 32; ++c) {
        const int col = lane + 32 * c, kpos = k0 + col;
        const bool live = qpos < S && kpos < S && (!causal || kpos <= qpos);
        const float p = live ? expf(sm.s[r * LS + col] * scale - sm.lse[r]) : 0.0f;
        sm.p[r * LP + col] = from_f<T>(p);
        sm.ds[r * LP + col] = from_f<T>(p * (sm.dp[r * LS + col] - sm.delta[r]));
      }
    }
    __syncthreads();  // P and dS of all query rows feed every key row
    // this warp's 16 key rows: dv += p^T dO, dk += ds^T q
    for (int j = 0; j < HD; j += 16) {
      mma16<T, wmma::col_major, wmma::row_major, BM>(
          sm.dv + r0 * LA + j, LA, sm.p + r0, LP, sm.dout + j, LT, true);
      mma16<T, wmma::col_major, wmma::row_major, BM>(
          sm.dk + r0 * LA + j, LA, sm.ds + r0, LP, sm.q + j, LT, true);
    }
  }
  __syncwarp();
  for (int rr = 0; rr < 16; ++rr) {
    const int r = r0 + rr, kpos = k0 + r;
    if (kpos >= S) break;
    for (int d = lane; d < HD; d += 32) {
      dk[base + (size_t)kpos * HD + d] = from_f<T>(sm.dk[r * LA + d] * scale);
      dv[base + (size_t)kpos * HD + d] = from_f<T>(sm.dv[r * LA + d]);
    }
  }
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T, int HD>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                int BH, int S, int causal, float scale, cudaStream_t st) {
  const size_t smem = FwdSmem<T, HD>(0).bytes;
  cudaError_t e = prepare(flash_fwd_kernel<T, HD>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((S + BM - 1) / BM, BH);
  flash_fwd_kernel<T, HD><<<grid, NTHREADS, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse, S, causal, scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t dq(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const void* lse, void* dqo, void* delta, int BH,
               int S, int causal, float scale, cudaStream_t st) {
  const size_t smem = DqSmem<T, HD>(0).bytes;
  cudaError_t e = prepare(flash_dq_kernel<T, HD>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((S + BM - 1) / BM, BH);
  flash_dq_kernel<T, HD><<<grid, NTHREADS, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)o, (const T*)dout,
      (const float*)lse, (T*)dqo, (float*)delta, S, causal, scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t dkv(const void* q, const void* k, const void* v, const void* dout,
                const void* lse, const void* delta, void* dko, void* dvo, int BH,
                int S, int causal, float scale, cudaStream_t st) {
  const size_t smem = DkvSmem<T, HD>(0).bytes;
  cudaError_t e = prepare(flash_dkv_kernel<T, HD>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((S + BN - 1) / BN, BH);
  flash_dkv_kernel<T, HD><<<grid, NTHREADS, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const float*)lse,
      (const float*)delta, (T*)dko, (T*)dvo, S, causal, scale);
  return cudaGetLastError();
}

}  // namespace kf_flash

// dtype: 0 = bf16, 1 = fp16. hd: 64 or 128. Each launcher enqueues one
// kernel on `stream`, allocates nothing, does not synchronise, and returns
// cudaGetLastError() (cudaErrorInvalidValue for an unsupported dtype/hd).
#define KF_DISPATCH(CALL)                                                   \
  do {                                                                      \
    if (dtype == 0 && hd == 64) return (int)CALL(__nv_bfloat16, 64);        \
    if (dtype == 0 && hd == 128) return (int)CALL(__nv_bfloat16, 128);      \
    if (dtype == 1 && hd == 64) return (int)CALL(__half, 64);               \
    if (dtype == 1 && hd == 128) return (int)CALL(__half, 128);             \
    return (int)cudaErrorInvalidValue;                                      \
  } while (0)

extern "C" {

int kf_flash_fwd(const void* q, const void* k, const void* v, void* o,
                 void* lse, int BH, int S, int hd, int dtype, int causal,
                 float scale, void* stream) {
#define KF_CALL(T, HD) \
  kf_flash::fwd<T, HD>(q, k, v, o, lse, BH, S, causal, scale, (cudaStream_t)stream)
  KF_DISPATCH(KF_CALL);
#undef KF_CALL
}

int kf_flash_dq(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const void* lse, void* dq, void* delta,
                int BH, int S, int hd, int dtype, int causal, float scale,
                void* stream) {
#define KF_CALL(T, HD)                                                  \
  kf_flash::dq<T, HD>(q, k, v, o, dout, lse, dq, delta, BH, S, causal, \
                      scale, (cudaStream_t)stream)
  KF_DISPATCH(KF_CALL);
#undef KF_CALL
}

int kf_flash_dkv(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dk, void* dv, int BH, int S, int hd, int dtype,
                 int causal, float scale, void* stream) {
#define KF_CALL(T, HD)                                                      \
  kf_flash::dkv<T, HD>(q, k, v, dout, lse, delta, dk, dv, BH, S, causal,   \
                       scale, (cudaStream_t)stream)
  KF_DISPATCH(KF_CALL);
#undef KF_CALL
}

const char* kf_flash_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
