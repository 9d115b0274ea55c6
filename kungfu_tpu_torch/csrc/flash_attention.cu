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
// Common to all three. One block owns one 64-row tile of one head: the TPU
// grid's sequential last dimension, which carried m/l/acc and the dq/dk/dv
// sums in VMEM across grid steps, becomes a loop inside the block. Products
// run on the tensor cores with bf16/fp16 operands and f32 sums -- unlike the
// TPU kernels, which upcast q/k/v to f32 before every dot -- so parity with
// the f32 reference holds at bf16 tolerance. Causal loops are bounded at the
// live tiles (forward and dQ stop at the diagonal tile, dK/dV start at it)
// instead of the TPU's clamped fetch indices. An uneven S is masked inside
// the kernels (zero rows past S, dead keys masked), where the JAX package
// falls back to dense attention.
//
// What bounds them on the H100: at the BERT-base shape (B*H=96, S=512, hd=64,
// causal) each kernel moves 25-38 MB and does 3-7 GFLOP over the live pairs,
// so the memory bound (8-11 us at 3.35 TB/s) is above the tensor-core bound.
// Neither roof decides: a query (key) tile has only 1 to 8 tiles to loop
// over, and each tile is a chain of dependent products and softmax work.
//
// All three are warp-specialised (hopper.cuh): one producer warp keeps a
// 2-stage shared-memory ring full by TMA, with mbarriers for "full" and
// "empty", and one consumer warpgroup runs wgmma on the tiles with every
// score, probability and sum in registers. Several blocks share an SM (4
// forward, 3 dQ, 2 dK/dV at hd = 64), and their tiles interleave. Their
// notes are at each kernel.
//
// What is still left on the table. Tried on the H100 and not kept, because
// none was faster at the slice's shape: issuing the next tile's products
// before the softmax of this one inside a warpgroup (FlashAttention-3's
// intra-warpgroup overlap, forward and dK/dV), a persistent forward grid,
// and two warpgroups sharing each K/V tile (half the L2 traffic); the blocks
// that share an SM already overlap one another. Not tried: 128-key tiles
// (half the per-tile barrier, shuffle and rescale work, but twice the score
// registers), and stores of O, dQ, dK and dV through shared memory and TMA
// instead of 4-byte stores from registers.
#include "flash_attention.cuh"
#include "hopper.cuh"

namespace kf_flash {

using namespace kf_hopper;

constexpr int HTHREADS = 128 + 32;  // one consumer warpgroup, one producer warp
constexpr int PRODUCER_WARP = 4;
constexpr int STAGES = 2;           // depth of the rings of streamed tiles

// The 128-byte swizzle of TMA and wgmma assumes tiles at 1024-byte
// boundaries; every launch asks for 1024 bytes more to align the base.
__device__ __forceinline__ char* align1024(char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

template <int HD> struct FwdLayout {
  static constexpr int TILE = HD / BOX * BOX_BYTES;  // one 64 x HD tile
  static constexpr int Q = 0;
  static constexpr int KV = TILE;  // stage s: K at KV + 2 * TILE * s, V after it
  static constexpr int BAR = KV + STAGES * 2 * TILE;  // q, full[], empty[]
  static constexpr int BYTES = BAR + 8 * (1 + 2 * STAGES) + 1024;
};

// Online softmax of one tile of raw scores s (the m64n64 fragment: rows r
// and r + 8, see acc_to_a) against the running max m (raw units) and this
// thread's part of the running sum l. Leaves the factor that rescales the
// earlier sums in corr, and P, rounded to 16 bits, as the register A operand
// of the P.V product in pa.
template <typename T>
__device__ __forceinline__ void softmax_tile(const float (&s)[32], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             uint32_t (&pa)[4][4], bool edge, int k0,
                                             int q0, int r, int t, int S, int causal,
                                             float scale_log2) {
  float x[32];
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    x[i] = s[i];
    if (edge) {
      const int kpos = k0 + 2 * t + acc_col(i), qpos = q0 + r + acc_row(i);
      if (kpos >= S || (causal && kpos > qpos)) x[i] = NEG_INF;
    }
    mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], x[i]);
  }
  float ms[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
    mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
    corr[j] = fast_exp2((m[j] - mx[j]) * scale_log2);
    m[j] = mx[j];
    ms[j] = mx[j] * scale_log2;
    l[j] *= corr[j];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    x[i] = fast_exp2(fmaf(x[i], scale_log2, -ms[(i / 2) % 2]));
    l[(i / 2) % 2] += x[i];
  }
  acc_to_a<T>(x, pa);
}

// O = softmax(q k^T * scale [causal]) v and lse = m + log(l) for one 64-row
// query tile, by online softmax over the key tiles (FlashAttention-3 shape).
//
// Bound at the slice's shape: bytes (7.6 us), but what limits it is the
// latency of each key tile: two dependent products and a softmax. Design:
// query tiles heaviest first (the causal diagonal ones need the most key
// tiles); Q arrives once by TMA and K/V tiles of 64 keys through the ring,
// each through a 3-D tensor map (hd, S, B*H) so that a box never reaches into
// the next head and rows past S arrive as zeros. S = Q K^T is a wgmma from
// shared memory into registers; the online softmax runs on the accumulator
// fragment (a row's max and sum are shuffles over the 4 threads that hold
// it; exp2 with scale*log2(e) folded into one FMA; only the diagonal and the
// ragged last tile are masked); P is rounded in registers into the A operand
// of O += P V, with V read from shared memory as the MN-major B operand. O
// stays in f32 registers from the first tile to the epilogue. At hd = 64 a
// block holds 41 KB of shared memory (the simple design: 70.5 KB).
template <typename T, int HD>
__global__ void __launch_bounds__(HTHREADS, HD == 64 ? 3 : 2)
flash_fwd_kernel(__grid_constant__ const CUtensorMap tq,
                 __grid_constant__ const CUtensorMap tk,
                 __grid_constant__ const CUtensorMap tv, T* __restrict__ o,
                 float* __restrict__ lse, int S, int causal, float scale_log2) {
  using L = FwdLayout<HD>;
  constexpr int NH = HD / BOX;  // 64-column halves of a row
  extern __shared__ __align__(1024) char smem_tiles[];
  char* sm = align1024(smem_tiles);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + STAGES;

  const int bh = blockIdx.x, qt = gridDim.y - 1 - blockIdx.y, q0 = qt * BM;
  const int n_all = (S + BN - 1) / BN;
  const int n_kt = causal ? min(n_all, qt + 1) : n_all;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == PRODUCER_WARP) {
    if (lane == 0) {
      mbar_arrive_expect_tx(qbar, L::TILE);
      for (int h = 0; h < NH; ++h)
        tma_load_3d(sm + L::Q + h * BOX_BYTES, &tq, qbar, h * BOX, q0, bh);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % STAGES;
        mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);
        char* kv = sm + L::KV + s * 2 * L::TILE;
        mbar_arrive_expect_tx(&full[s], 2 * L::TILE);
        for (int h = 0; h < NH; ++h) {
          tma_load_3d(kv + h * BOX_BYTES, &tk, &full[s], h * BOX, kt * BN, bh);
          tma_load_3d(kv + L::TILE + h * BOX_BYTES, &tv, &full[s], h * BOX, kt * BN, bh);
        }
      }
    }
    return;
  }

  // consumer warpgroup; this thread holds rows r and r + 8 of the tile
  const int g = lane / 4, t = lane % 4, r = warp * 16 + g;
  const char* qs = sm + L::Q;
  float acc[NH][32];
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] = 0.0f;
  float m[2] = {NEG_INF, NEG_INF};  // running max of the raw scores
  float l[2] = {0.0f, 0.0f};        // this thread's part of the running sum
  mbar_wait(qbar, 0);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt % STAGES, k0 = kt * BN;
    mbar_wait(&full[s], (kt / STAGES) & 1);
    const char* ks = sm + L::KV + s * 2 * L::TILE;
    const char* vs = ks + L::TILE;

    float sc[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
      wgmma_ss<T>(sc, desc_k(qs + off), desc_k(ks + off), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(sc);

    float corr[2];
    uint32_t pa[4][4];
    softmax_tile<T>(sc, m, l, corr, pa, (causal && kt == qt) || k0 + BN > S, k0, q0, r, t,
                    S, causal, scale_log2);
    // a warp whose rows kept their max has nothing to rescale
    if (__any_sync(0xffffffffu, corr[0] != 1.0f || corr[1] != 1.0f))
#pragma unroll
      for (int h = 0; h < NH; ++h)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[h][i] *= corr[(i / 2) % 2];

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int h = 0; h < NH; ++h)
        wgmma_rs<T>(acc[h], pa[kk], desc_mn(vs + h * BOX_BYTES + kk * 2048), 1);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < NH; ++h) reg_fence(acc[h]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int j = 0; j < 2; ++j) {
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 1);
    l[j] += __shfl_xor_sync(0xffffffffu, l[j], 2);
  }
  const float inv[2] = {1.0f / l[0], 1.0f / l[1]};
  const size_t base = (size_t)bh * S;
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int row = q0 + r + acc_row(i);
      if (row < S) {
        const int col = h * BOX + 2 * t + acc_col(i);
        const float f = inv[(i / 2) % 2];
        *reinterpret_cast<uint32_t*>(o + (base + row) * HD + col) =
            pack2<T>(acc[h][i] * f, acc[h][i + 1] * f);
      }
    }
  if (t == 0)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int row = q0 + r + 8 * j;
      if (row < S) lse[base + row] = m[j] * scale_log2 * LN2 + logf(l[j]);
    }
}

template <int HD> struct DqLayout {
  static constexpr int TILE = HD / BOX * BOX_BYTES;
  static constexpr int Q = 0, DO = TILE, O = 2 * TILE;
  static constexpr int KV = 3 * TILE;  // stage s: K at KV + 2 * TILE * s, V after it
  static constexpr int DELTA = KV + STAGES * 2 * TILE;  // 64 f32
  static constexpr int BAR = DELTA + 4 * BM;  // Q/dO/O, full[], empty[]
  static constexpr int BYTES = BAR + 8 * (1 + 2 * STAGES) + 1024;
};

// Sum of the products of eight 16-bit pairs, in f32.
template <typename T>
__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const uint32_t* x = &a.x;
  const uint32_t* y = &b.x;
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 u = unpack2<T>(x[j]), w = unpack2<T>(y[j]);
    s = fmaf(u.x, w.x, fmaf(u.y, w.y, s));
  }
  return s;
}

// dq = sum_k ds k * scale for one 64-row query tile, with p = exp(q k^T *
// scale - lse) and ds = p * (dO v^T - delta), as _dq_kernel computes it
// (kungfu_tpu/ops/flash_attention.py:228-272, pallas_call at :368). delta =
// rowsum(dO * O) is computed here, once per query row, and written out for
// the dK/dV kernel (the JAX package leaves it to a separate XLA pass).
//
// Bound at the slice's shape: bytes (11.4 us), but, as in the other two, the
// latency of each key tile limits it: three products, the third dependent
// on the first two. Design: the forward's block, so that several blocks
// share an SM and overlap one another's chains. Q, dO and O arrive once by
// TMA, K/V tiles through the ring; delta, needed before the first dS, is
// formed in the prologue as a rowsum over the same swizzled positions of
// the dO and O tiles in shared memory (the 128-byte swizzle permutes 16-byte
// chunks inside a row alike in both), two threads a row with 16-byte
// loads, finished by one shuffle and a barrier of the consumer warpgroup
// alone. S = Q K^T and dP = dO V^T are wgmmas from shared memory into
// registers in one group; P and dS are computed in registers (exp2 with
// the scale folded into one FMA; only the diagonal and the ragged last tile
// are masked) and dS becomes the register A operand of dQ += dS K, with K
// read from shared memory as the MN-major B operand. dQ stays in f32
// registers from the first tile to the epilogue. Query tiles run heaviest
// first. About 58 KB of shared memory at hd = 64.
template <typename T, int HD>
__global__ void __launch_bounds__(HTHREADS, HD == 64 ? 3 : 1)
flash_dq_kernel(__grid_constant__ const CUtensorMap tq,
                __grid_constant__ const CUtensorMap tk,
                __grid_constant__ const CUtensorMap tv,
                __grid_constant__ const CUtensorMap to,
                __grid_constant__ const CUtensorMap tdo,
                const float* __restrict__ lse, T* __restrict__ dq,
                float* __restrict__ delta, int S, int causal, float scale,
                float scale_log2) {
  using L = DqLayout<HD>;
  constexpr int NH = HD / BOX;
  extern __shared__ __align__(1024) char smem_tiles[];
  char* sm = align1024(smem_tiles);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + STAGES;

  const int bh = blockIdx.x, qt = gridDim.y - 1 - blockIdx.y, q0 = qt * BM;
  const int n_all = (S + BN - 1) / BN;
  const int n_kt = causal ? min(n_all, qt + 1) : n_all;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == PRODUCER_WARP) {
    if (lane == 0) {
      mbar_arrive_expect_tx(qbar, 3 * L::TILE);
      for (int h = 0; h < NH; ++h) {
        tma_load_3d(sm + L::Q + h * BOX_BYTES, &tq, qbar, h * BOX, q0, bh);
        tma_load_3d(sm + L::DO + h * BOX_BYTES, &tdo, qbar, h * BOX, q0, bh);
        tma_load_3d(sm + L::O + h * BOX_BYTES, &to, qbar, h * BOX, q0, bh);
      }
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % STAGES;
        mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);
        char* kv = sm + L::KV + s * 2 * L::TILE;
        mbar_arrive_expect_tx(&full[s], 2 * L::TILE);
        for (int h = 0; h < NH; ++h) {
          tma_load_3d(kv + h * BOX_BYTES, &tk, &full[s], h * BOX, kt * BN, bh);
          tma_load_3d(kv + L::TILE + h * BOX_BYTES, &tv, &full[s], h * BOX, kt * BN, bh);
        }
      }
    }
    return;
  }

  // consumer warpgroup; this thread holds rows r and r + 8 of the tile
  const int g = lane / 4, t = lane % 4, r = warp * 16 + g;
  const size_t base = (size_t)bh * S;
  float ls[2];  // lse * log2(e) of rows r and r + 8; 0 past S
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = q0 + r + 8 * j;
    ls[j] = row < S ? lse[base + row] * LOG2E : 0.0f;
  }
  const char* qs = sm + L::Q;
  const char* dos = sm + L::DO;
  float* dl = reinterpret_cast<float*>(sm + L::DELTA);
  mbar_wait(qbar, 0);

  {  // delta: thread pair (2e, 2e + 1) sums row e, 4 * NH chunks of 16 bytes each
    const int e = threadIdx.x / 2, c0 = (threadIdx.x % 2) * 4;
    const char* os = sm + L::O;
    float d = 0.0f;
#pragma unroll
    for (int i = 0; i < 4 * NH; ++i) {
      const int off = (i / 4) * BOX_BYTES + e * 128 + (c0 + i % 4) * 16;
      d += dot8<T>(*reinterpret_cast<const uint4*>(dos + off),
                   *reinterpret_cast<const uint4*>(os + off));
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if (c0 == 0) {
      dl[e] = d;
      if (q0 + e < S) delta[base + q0 + e] = d;
    }
  }
  named_bar_sync(1, 128);
  const float dr[2] = {dl[r], dl[r + 8]};

  float acc[NH][32];
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] = 0.0f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt % STAGES, k0 = kt * BN;
    mbar_wait(&full[s], (kt / STAGES) & 1);
    const char* ks = sm + L::KV + s * 2 * L::TILE;
    const char* vs = ks + L::TILE;

    float sc[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
      wgmma_ss<T>(sc, desc_k(qs + off), desc_k(ks + off), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
      wgmma_ss<T>(dp, desc_k(dos + off), desc_k(vs + off), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(sc);
    reg_fence(dp);

    const bool edge = (causal && kt == qt) || k0 + BN > S;
    float ds[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float p = fast_exp2(fmaf(sc[i], scale_log2, -ls[(i / 2) % 2]));
      if (edge) {
        const int kpos = k0 + 2 * t + acc_col(i), qpos = q0 + r + acc_row(i);
        if (kpos >= S || (causal && kpos > qpos)) p = 0.0f;
      }
      ds[i] = p * (dp[i] - dr[(i / 2) % 2]);
    }
    uint32_t da[4][4];
    acc_to_a<T>(ds, da);

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int h = 0; h < NH; ++h)
        wgmma_rs<T>(acc[h], da[kk], desc_mn(ks + h * BOX_BYTES + kk * 2048), 1);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < NH; ++h) reg_fence(acc[h]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int row = q0 + r + acc_row(i);
      if (row < S) {
        const int col = h * BOX + 2 * t + acc_col(i);
        *reinterpret_cast<uint32_t*>(dq + (base + row) * HD + col) =
            pack2<T>(acc[h][i] * scale, acc[h][i + 1] * scale);
      }
    }
}

template <int HD> struct DkvLayout {
  static constexpr int TILE = HD / BOX * BOX_BYTES;
  static constexpr int K = 0, V = TILE;
  // stage s at RING + STAGE * s: Q, dO, then lse * log2(e) and delta (64 f32
  // each); the stage is padded to keep the next one 1024-byte aligned
  static constexpr int RING = 2 * TILE;
  static constexpr int STAGE = 2 * TILE + 1024;
  static constexpr int BAR = RING + STAGES * STAGE;  // kv, full[], empty[]
  static constexpr int BYTES = BAR + 8 * (1 + 2 * STAGES) + 1024;
};

// dv = sum_q p^T dO and dk = sum_q ds^T q * scale for one 64-row key tile,
// over the live query tiles (causal: from the diagonal tile on), in the
// transposed formulation: p^T = exp(k q^T * scale - lse), ds^T = p^T *
// (v dO^T - delta).
//
// Bound at the slice's shape: bytes (11.4 us), but, as in the forward, the
// latency of each query tile (four products, two of them dependent on the
// other two) limits it. The simple design also held every f32 sum and all
// of P and dS in shared memory (122.5 KB, one block per SM) and needed a
// block-wide barrier per query tile because every warp's rows of P fed every
// key row. Design: the consumer warpgroup owns all 64 key rows, so nothing
// crosses warpgroups: K and V arrive once by TMA; Q, dO and the tile's lse
// and delta stream through the ring (tiles by TMA, the two f32 rows by the
// producer warp's lanes); S^T = K Q^T and dP^T = V dO^T are wgmmas from
// shared memory into registers; P^T and dS^T are computed in registers and
// become the register A operands of dV += P^T dO and dK += dS^T Q, with dO
// and Q read from shared memory as MN-major B operands. dK and dV stay in
// f32 registers for the whole block; each block owns its output rows, so
// there are no atomics and the result is deterministic. About 50 KB of
// shared memory at hd = 64.
template <typename T, int HD>
__global__ void __launch_bounds__(HTHREADS, HD == 64 ? 2 : 1)
flash_dkv_kernel(__grid_constant__ const CUtensorMap tq,
                 __grid_constant__ const CUtensorMap tk,
                 __grid_constant__ const CUtensorMap tv,
                 __grid_constant__ const CUtensorMap tdo,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 T* __restrict__ dk, T* __restrict__ dv, int S, int causal,
                 float scale, float scale_log2) {
  using L = DkvLayout<HD>;
  constexpr int NH = HD / BOX;
  extern __shared__ __align__(1024) char smem_tiles[];
  char* sm = align1024(smem_tiles);
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* full = kvbar + 1;
  uint64_t* empty = full + STAGES;

  const int bh = blockIdx.x, kt = blockIdx.y, k0 = kt * BN;
  const int n_qt = (S + BM - 1) / BM;
  const int qt0 = causal ? kt : 0;  // BM == BN: the diagonal tile
  const int n = n_qt - qt0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32);  // every producer lane, after its lse/delta
      mbar_init(&empty[s], 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == PRODUCER_WARP) {
    if (lane == 0) {
      mbar_arrive_expect_tx(kvbar, 2 * L::TILE);
      for (int h = 0; h < NH; ++h) {
        tma_load_3d(sm + L::K + h * BOX_BYTES, &tk, kvbar, h * BOX, k0, bh);
        tma_load_3d(sm + L::V + h * BOX_BYTES, &tv, kvbar, h * BOX, k0, bh);
      }
    }
    for (int j = 0; j < n; ++j) {
      const int s = j % STAGES, q0 = (qt0 + j) * BM;
      mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
      char* st = sm + L::RING + s * L::STAGE;
      float* ls = reinterpret_cast<float*>(st + 2 * L::TILE);
      float* ds = ls + BM;
      for (int e = lane; e < BM; e += 32) {
        const int qpos = q0 + e;
        ls[e] = qpos < S ? lse[(size_t)bh * S + qpos] * LOG2E : 0.0f;
        ds[e] = qpos < S ? delta[(size_t)bh * S + qpos] : 0.0f;
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[s], 2 * L::TILE);
        for (int h = 0; h < NH; ++h) {
          tma_load_3d(st + h * BOX_BYTES, &tq, &full[s], h * BOX, q0, bh);
          tma_load_3d(st + L::TILE + h * BOX_BYTES, &tdo, &full[s], h * BOX, q0, bh);
        }
      } else {
        mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // consumer warpgroup; this thread holds key rows r and r + 8 of the tile
  const int g = lane / 4, t = lane % 4, r = warp * 16 + g;
  const char* ks = sm + L::K;
  const char* vs = sm + L::V;
  float dka[NH][32], dva[NH][32];
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) dka[h][i] = dva[h][i] = 0.0f;
  mbar_wait(kvbar, 0);

  for (int j = 0; j < n; ++j) {
    const int s = j % STAGES, qt = qt0 + j, q0 = qt * BM;
    mbar_wait(&full[s], (j / STAGES) & 1);
    const char* qs = sm + L::RING + s * L::STAGE;
    const char* dos = qs + L::TILE;
    const float* ls = reinterpret_cast<const float*>(qs + 2 * L::TILE);
    const float* dls = ls + BM;

    float p[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
      wgmma_ss<T>(p, desc_k(ks + off), desc_k(qs + off), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
      wgmma_ss<T>(dp, desc_k(vs + off), desc_k(dos + off), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(p);
    reg_fence(dp);

    const bool edge = (causal && qt == kt) || q0 + BM > S;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = 2 * t + acc_col(i);
      float x = fast_exp2(fmaf(p[i], scale_log2, -ls[c]));
      if (edge) {
        const int qpos = q0 + c, kpos = k0 + r + acc_row(i);
        if (qpos >= S || (causal && kpos > qpos)) x = 0.0f;
      }
      p[i] = x;
      dp[i] = x * (dp[i] - dls[c]);
    }
    uint32_t pa[4][4], da[4][4];
    acc_to_a<T>(p, pa);
    acc_to_a<T>(dp, da);

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk)
#pragma unroll
      for (int h = 0; h < NH; ++h) {
        wgmma_rs<T>(dva[h], pa[kk], desc_mn(dos + h * BOX_BYTES + kk * 2048), 1);
        wgmma_rs<T>(dka[h], da[kk], desc_mn(qs + h * BOX_BYTES + kk * 2048), 1);
      }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      reg_fence(dka[h]);
      reg_fence(dva[h]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  const size_t base = (size_t)bh * S;
#pragma unroll
  for (int h = 0; h < NH; ++h)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int row = k0 + r + acc_row(i);
      if (row < S) {
        const size_t at = (base + row) * HD + h * BOX + 2 * t + acc_col(i);
        *reinterpret_cast<uint32_t*>(dk + at) =
            pack2<T>(dka[h][i] * scale, dka[h][i + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + at) = pack2<T>(dva[h][i], dva[h][i + 1]);
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
  const int n_qt = (S + BM - 1) / BM;
  if (n_qt > 65535) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  cudaError_t e;
  if ((e = bind_device_of(q)) != cudaSuccess) return e;
  if ((e = make_map<T>(&tq, q, BH, S, HD)) != cudaSuccess) return e;
  if ((e = make_map<T>(&tk, k, BH, S, HD)) != cudaSuccess) return e;
  if ((e = make_map<T>(&tv, v, BH, S, HD)) != cudaSuccess) return e;
  const size_t smem = FwdLayout<HD>::BYTES;
  if ((e = prepare(flash_fwd_kernel<T, HD>, smem)) != cudaSuccess) return e;
  flash_fwd_kernel<T, HD><<<dim3(BH, n_qt), HTHREADS, smem, st>>>(
      tq, tk, tv, (T*)o, (float*)lse, S, causal, scale * LOG2E);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t dq(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const void* lse, void* dqo, void* delta, int BH,
               int S, int causal, float scale, cudaStream_t st) {
  const int n_qt = (S + BM - 1) / BM;
  if (n_qt > 65535) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, to, tdo;
  cudaError_t e;
  if ((e = bind_device_of(q)) != cudaSuccess) return e;
  if ((e = make_map<T>(&tq, q, BH, S, HD)) != cudaSuccess) return e;
  if ((e = make_map<T>(&tk, k, BH, S, HD)) != cudaSuccess) return e;
  if ((e = make_map<T>(&tv, v, BH, S, HD)) != cudaSuccess) return e;
  if ((e = make_map<T>(&to, o, BH, S, HD)) != cudaSuccess) return e;
  if ((e = make_map<T>(&tdo, dout, BH, S, HD)) != cudaSuccess) return e;
  const size_t smem = DqLayout<HD>::BYTES;
  if ((e = prepare(flash_dq_kernel<T, HD>, smem)) != cudaSuccess) return e;
  flash_dq_kernel<T, HD><<<dim3(BH, n_qt), HTHREADS, smem, st>>>(
      tq, tk, tv, to, tdo, (const float*)lse, (T*)dqo, (float*)delta, S, causal, scale,
      scale * LOG2E);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t dkv(const void* q, const void* k, const void* v, const void* dout,
                const void* lse, const void* delta, void* dko, void* dvo, int BH,
                int S, int causal, float scale, cudaStream_t st) {
  const int n_kt = (S + BN - 1) / BN;
  if (n_kt > 65535) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t e;
  if ((e = bind_device_of(q)) != cudaSuccess) return e;
  if ((e = make_map<T>(&tq, q, BH, S, HD)) != cudaSuccess) return e;
  if ((e = make_map<T>(&tk, k, BH, S, HD)) != cudaSuccess) return e;
  if ((e = make_map<T>(&tv, v, BH, S, HD)) != cudaSuccess) return e;
  if ((e = make_map<T>(&tdo, dout, BH, S, HD)) != cudaSuccess) return e;
  const size_t smem = DkvLayout<HD>::BYTES;
  if ((e = prepare(flash_dkv_kernel<T, HD>, smem)) != cudaSuccess) return e;
  flash_dkv_kernel<T, HD><<<dim3(BH, n_kt), HTHREADS, smem, st>>>(
      tq, tk, tv, tdo, (const float*)lse, (const float*)delta, (T*)dko, (T*)dvo, S,
      causal, scale, scale * LOG2E);
  return cudaGetLastError();
}

// out = {dynamic shared bytes, active blocks per SM, registers per thread,
// local (spilled) bytes per thread} of one kernel's launch configuration.
template <typename Kernel>
cudaError_t occupancy_of(Kernel kernel, int threads, size_t smem, int* out) {
  cudaError_t e = prepare(kernel, smem);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  if ((e = cudaFuncGetAttributes(&attr, kernel)) != cudaSuccess) return e;
  out[0] = (int)smem;
  out[2] = attr.numRegs;
  out[3] = (int)attr.localSizeBytes;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], kernel, threads, smem);
}

template <typename T, int HD>
cudaError_t occupancy(int which, int* out) {
  if (which == 0)
    return occupancy_of(flash_fwd_kernel<T, HD>, HTHREADS, FwdLayout<HD>::BYTES, out);
  if (which == 1)
    return occupancy_of(flash_dq_kernel<T, HD>, HTHREADS, DqLayout<HD>::BYTES, out);
  if (which == 2)
    return occupancy_of(flash_dkv_kernel<T, HD>, HTHREADS, DkvLayout<HD>::BYTES, out);
  return cudaErrorInvalidValue;
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

// kernel: 0 = forward, 1 = dQ, 2 = dK/dV; fills out[4] (see occupancy_of).
int kf_flash_occupancy(int kernel, int hd, int dtype, int* out) {
#define KF_CALL(T, HD) kf_flash::occupancy<T, HD>(kernel, out)
  KF_DISPATCH(KF_CALL);
#undef KF_CALL
}

const char* kf_flash_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
