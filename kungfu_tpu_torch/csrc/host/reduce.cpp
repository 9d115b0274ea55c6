// Host-side SIMD reduction and wire codec of the host plane's collective
// engine: the port's own copy of native/reduce.cpp, the same code.
//
// Built with the host C++ compiler at first use (kungfu_tpu_torch/ops/
// _build.py, compile_host_library) into a plain-C library that
// kungfu_tpu_torch/base/_native.py binds with ctypes; auto-vectorized by
// -O3 -march=native (bf16 handled as widened float ops — no AVX512-BF16
// assumption). It runs on the host, the same on every machine: card
// gradients reach it through pinned host buffers.
//
// ABI: kf_transform2(dst, x, y, count, dtype, op) -> 0 ok / -1 unsupported.
// dtype codes match kungfu_tpu_torch.base.dtype.DType; op codes ReduceOp.

#include <cstdint>
#include <cstddef>

namespace {

enum DTypeCode : int32_t {
  U8 = 1, I8 = 2, I16 = 3, I32 = 4, I64 = 5,
  U16 = 6, U32 = 7, U64 = 8,
  F16 = 9, BF16 = 10, F32 = 11, F64 = 12,
};

enum OpCode : int32_t { SUM = 0, MIN = 1, MAX = 2, PROD = 3 };

template <typename T, typename Op>
void apply(T *dst, const T *x, const T *y, size_t n, Op op) {
  for (size_t i = 0; i < n; ++i) dst[i] = op(x[i], y[i]);
}

template <typename T>
int run(T *dst, const T *x, const T *y, size_t n, int32_t op) {
  switch (op) {
    case SUM:  apply(dst, x, y, n, [](T a, T b) { return static_cast<T>(a + b); }); return 0;
    case MIN:  apply(dst, x, y, n, [](T a, T b) { return a < b ? a : b; }); return 0;
    case MAX:  apply(dst, x, y, n, [](T a, T b) { return a > b ? a : b; }); return 0;
    case PROD: apply(dst, x, y, n, [](T a, T b) { return static_cast<T>(a * b); }); return 0;
  }
  return -1;
}

// --- 16-bit float formats, widened to f32 lane-wise --------------------

inline float half_to_float(uint16_t h) {
  uint32_t sign = (uint32_t)(h >> 15) << 31;
  uint32_t exp = (h >> 10) & 0x1f;
  uint32_t man = h & 0x3ff;
  uint32_t bits;
  if (exp == 0) {
    if (man == 0) {
      bits = sign;
    } else {  // subnormal
      exp = 127 - 15 + 1;
      while (!(man & 0x400)) { man <<= 1; --exp; }
      man &= 0x3ff;
      bits = sign | (exp << 23) | (man << 13);
    }
  } else if (exp == 0x1f) {
    bits = sign | 0x7f800000u | (man << 13);
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (man << 13);
  }
  float out;
  __builtin_memcpy(&out, &bits, 4);
  return out;
}

inline uint16_t float_to_half(float f) {
  uint32_t bits;
  __builtin_memcpy(&bits, &f, 4);
  uint16_t sign = (uint16_t)((bits >> 16) & 0x8000u);
  int32_t exp = (int32_t)((bits >> 23) & 0xff) - 127 + 15;
  uint32_t man = bits & 0x7fffffu;
  if (exp >= 0x1f) return (uint16_t)(sign | 0x7c00u | ((((bits >> 23) & 0xff) == 0xff && man) ? 0x200 : 0));
  if (exp <= 0) {
    if (exp < -10) return sign;
    man |= 0x800000u;
    uint32_t shift = (uint32_t)(14 - exp);
    uint16_t h = (uint16_t)(sign | (man >> shift));
    if ((man >> (shift - 1)) & 1) h = (uint16_t)(h + 1);  // round-to-nearest
    return h;
  }
  uint16_t h = (uint16_t)(sign | ((uint32_t)exp << 10) | (man >> 13));
  if (man & 0x1000u) h = (uint16_t)(h + 1);
  return h;
}

inline float bf16_to_float(uint16_t b) {
  uint32_t bits = (uint32_t)b << 16;
  float out;
  __builtin_memcpy(&out, &bits, 4);
  return out;
}

inline uint16_t float_to_bf16(float f) {
  uint32_t bits;
  __builtin_memcpy(&bits, &f, 4);
  // round-to-nearest-even
  uint32_t rounding = 0x7fffu + ((bits >> 16) & 1);
  return (uint16_t)((bits + rounding) >> 16);
}

template <float (*Load)(uint16_t), uint16_t (*Store)(float)>
int run16(uint16_t *dst, const uint16_t *x, const uint16_t *y, size_t n, int32_t op) {
  switch (op) {
    case SUM:
      for (size_t i = 0; i < n; ++i) dst[i] = Store(Load(x[i]) + Load(y[i]));
      return 0;
    case MIN:
      for (size_t i = 0; i < n; ++i) {
        float a = Load(x[i]), b = Load(y[i]);
        dst[i] = Store(a < b ? a : b);
      }
      return 0;
    case MAX:
      for (size_t i = 0; i < n; ++i) {
        float a = Load(x[i]), b = Load(y[i]);
        dst[i] = Store(a > b ? a : b);
      }
      return 0;
    case PROD:
      for (size_t i = 0; i < n; ++i) dst[i] = Store(Load(x[i]) * Load(y[i]));
      return 0;
  }
  return -1;
}

}  // namespace

extern "C" int kf_transform2(void *dst, const void *x, const void *y,
                             int64_t count, int32_t dtype, int32_t op) {
  size_t n = (size_t)count;
  switch (dtype) {
    case U8:  return run((uint8_t *)dst, (const uint8_t *)x, (const uint8_t *)y, n, op);
    case I8:  return run((int8_t *)dst, (const int8_t *)x, (const int8_t *)y, n, op);
    case I16: return run((int16_t *)dst, (const int16_t *)x, (const int16_t *)y, n, op);
    case I32: return run((int32_t *)dst, (const int32_t *)x, (const int32_t *)y, n, op);
    case I64: return run((int64_t *)dst, (const int64_t *)x, (const int64_t *)y, n, op);
    case U16: return run((uint16_t *)dst, (const uint16_t *)x, (const uint16_t *)y, n, op);
    case U32: return run((uint32_t *)dst, (const uint32_t *)x, (const uint32_t *)y, n, op);
    case U64: return run((uint64_t *)dst, (const uint64_t *)x, (const uint64_t *)y, n, op);
    case F16: return run16<half_to_float, float_to_half>(
        (uint16_t *)dst, (const uint16_t *)x, (const uint16_t *)y, n, op);
    case BF16: return run16<bf16_to_float, float_to_bf16>(
        (uint16_t *)dst, (const uint16_t *)x, (const uint16_t *)y, n, op);
    case F32: return run((float *)dst, (const float *)x, (const float *)y, n, op);
    case F64: return run((double *)dst, (const double *)x, (const double *)y, n, op);
  }
  return -1;
}

// N-ary single-pass reduce: dst = srcs[0] op srcs[1] op ... op srcs[k-1].
// A STAR root receiving k-1 peers otherwise runs k-1 pairwise passes over
// dst (3x the memory traffic at np=4); one fused pass keeps the
// accumulator in registers. dst must not alias any src.
namespace {

template <typename T, typename Op>
int run_n(T *dst, const T *const *srcs, int32_t k, size_t n, Op op) {
  for (size_t i = 0; i < n; ++i) {
    T acc = srcs[0][i];
    for (int32_t j = 1; j < k; ++j) acc = op(acc, srcs[j][i]);
    dst[i] = acc;
  }
  return 0;
}

template <typename T>
int dispatch_n(T *dst, const T *const *srcs, int32_t k, size_t n, int32_t op) {
  switch (op) {
    case SUM:  return run_n(dst, srcs, k, n, [](T a, T b) { return static_cast<T>(a + b); });
    case MIN:  return run_n(dst, srcs, k, n, [](T a, T b) { return a < b ? a : b; });
    case MAX:  return run_n(dst, srcs, k, n, [](T a, T b) { return a > b ? a : b; });
    case PROD: return run_n(dst, srcs, k, n, [](T a, T b) { return static_cast<T>(a * b); });
  }
  return -1;
}

template <float (*Load)(uint16_t), uint16_t (*Store)(float)>
int dispatch_n16(uint16_t *dst, const uint16_t *const *srcs, int32_t k,
                 size_t n, int32_t op) {
  switch (op) {
    case SUM:
      for (size_t i = 0; i < n; ++i) {
        float acc = Load(srcs[0][i]);
        for (int32_t j = 1; j < k; ++j) acc += Load(srcs[j][i]);
        dst[i] = Store(acc);
      }
      return 0;
    case MIN:
      for (size_t i = 0; i < n; ++i) {
        float acc = Load(srcs[0][i]);
        for (int32_t j = 1; j < k; ++j) {
          float b = Load(srcs[j][i]);
          acc = acc < b ? acc : b;
        }
        dst[i] = Store(acc);
      }
      return 0;
    case MAX:
      for (size_t i = 0; i < n; ++i) {
        float acc = Load(srcs[0][i]);
        for (int32_t j = 1; j < k; ++j) {
          float b = Load(srcs[j][i]);
          acc = acc > b ? acc : b;
        }
        dst[i] = Store(acc);
      }
      return 0;
    case PROD:
      for (size_t i = 0; i < n; ++i) {
        float acc = Load(srcs[0][i]);
        for (int32_t j = 1; j < k; ++j) acc *= Load(srcs[j][i]);
        dst[i] = Store(acc);
      }
      return 0;
  }
  return -1;
}

}  // namespace

extern "C" int kf_transform_n(void *dst, const void *const *srcs, int32_t k,
                              int64_t count, int32_t dtype, int32_t op) {
  if (k < 1) return -1;
  size_t n = (size_t)count;
  switch (dtype) {
    case U8:  return dispatch_n((uint8_t *)dst, (const uint8_t *const *)srcs, k, n, op);
    case I8:  return dispatch_n((int8_t *)dst, (const int8_t *const *)srcs, k, n, op);
    case I16: return dispatch_n((int16_t *)dst, (const int16_t *const *)srcs, k, n, op);
    case I32: return dispatch_n((int32_t *)dst, (const int32_t *const *)srcs, k, n, op);
    case I64: return dispatch_n((int64_t *)dst, (const int64_t *const *)srcs, k, n, op);
    case U16: return dispatch_n((uint16_t *)dst, (const uint16_t *const *)srcs, k, n, op);
    case U32: return dispatch_n((uint32_t *)dst, (const uint32_t *const *)srcs, k, n, op);
    case U64: return dispatch_n((uint64_t *)dst, (const uint64_t *const *)srcs, k, n, op);
    case F16: return dispatch_n16<half_to_float, float_to_half>(
        (uint16_t *)dst, (const uint16_t *const *)srcs, k, n, op);
    case BF16: return dispatch_n16<bf16_to_float, float_to_bf16>(
        (uint16_t *)dst, (const uint16_t *const *)srcs, k, n, op);
    case F32: return dispatch_n((float *)dst, (const float *const *)srcs, k, n, op);
    case F64: return dispatch_n((double *)dst, (const double *const *)srcs, k, n, op);
  }
  return -1;
}

// --- wire codec (compressed host-plane collectives) --------------------
//
// f32 workspaces travel the wire as bf16/f16 while every reduce step
// accumulates into an f32 buffer, so rounding stays one quantization
// deep per transmitted value instead of compounding in 16-bit storage.
// kf_encode_wire / kf_decode_wire are the bulk converters; the fused
// kf_decode_accumulate does decode + reduce in one pass over the
// segment (the per-step hot path of the segmented ring walk).
//
// Rounding contract: both encoders round to nearest-even, bit-matching
// torch's f32->f16 conversion and the (bits + 0x7fff + lsb) >> 16 bf16
// fold of the plain twins in base/ops.py (asserted by the parity tests).

namespace {

// f32 -> f16 with round-to-nearest-even across normals, subnormals and
// overflow (the existing float_to_half rounds half-up; the codec must
// round to nearest-even exactly). Subnormal rounding rides an exponent-
// aligning float add: adding 2^-14 forces the result's ulp to the f16
// subnormal spacing, so the hardware's RNE does the rounding for us.
inline uint16_t f32_to_f16_rne(float ff) {
  uint32_t f;
  __builtin_memcpy(&f, &ff, 4);
  const uint32_t sign = f & 0x80000000u;
  f ^= sign;
  uint16_t out;
  if (f >= 0x7f800000u) {  // inf / nan
    out = (f > 0x7f800000u) ? (uint16_t)(0x7e00u | ((f >> 13) & 0x3ffu))
                            : (uint16_t)0x7c00u;
  } else if (f >= ((127u + 16u) << 23)) {  // >= 2^16: overflow to inf
    out = 0x7c00u;
  } else if (f < (113u << 23)) {  // < 2^-14: f16 subnormal or zero
    // align-to-ulp trick: 0.5f's f32 ulp (2^-24) IS the f16 subnormal
    // spacing, so adding it makes the hardware's RNE round the mantissa
    // to subnormal precision; the bits of (sum - 0.5f) are the mantissa
    const uint32_t magic = 126u << 23;  // 0.5f
    float tmp, magicf;
    __builtin_memcpy(&tmp, &f, 4);
    __builtin_memcpy(&magicf, &magic, 4);
    tmp += magicf;
    uint32_t t;
    __builtin_memcpy(&t, &tmp, 4);
    out = (uint16_t)(t - magic);
  } else {  // normal range: rebias exponent, RNE on bit 13
    const uint32_t mant_odd = (f >> 13) & 1u;
    f += ((uint32_t)(15 - 127) << 23) + 0xfffu + mant_odd;
    out = (uint16_t)(f >> 13);
  }
  return (uint16_t)(out | (sign >> 16));
}

template <float (*Load)(uint16_t)>
int decode_acc(float *acc, const uint16_t *src, size_t n, int32_t op) {
  switch (op) {
    case SUM:
      for (size_t i = 0; i < n; ++i) acc[i] += Load(src[i]);
      return 0;
    case MIN:
      for (size_t i = 0; i < n; ++i) {
        float b = Load(src[i]);
        acc[i] = acc[i] < b ? acc[i] : b;
      }
      return 0;
    case MAX:
      for (size_t i = 0; i < n; ++i) {
        float b = Load(src[i]);
        acc[i] = acc[i] > b ? acc[i] : b;
      }
      return 0;
    case PROD:
      for (size_t i = 0; i < n; ++i) acc[i] *= Load(src[i]);
      return 0;
  }
  return -1;
}

}  // namespace

// F16C fast paths: the scalar f16 converters are branchy (subnormal
// normalization loops) and defeat auto-vectorization — measured 2x
// SLOWER end-to-end than uncompressed on the bench box, where bf16's
// branchless integer fold vectorizes fine. vcvtps2ph/vcvtph2ps do the
// full IEEE round-to-nearest-even conversion (subnormals, overflow) in
// hardware, bit-matching the scalar RNE path — the same lever the reference
// pulls in srcs/go/kungfu/base/f16.c. Scalar tails + non-F16C builds
// keep the exact-RNE scalar fallbacks.
#if defined(__F16C__)
#include <immintrin.h>
#endif

namespace {

#if defined(__F16C__)
inline void encode_f16_bulk(uint16_t *d, const float *s, size_t n) {
  size_t i = 0;
  for (; i + 8 <= n; i += 8) {
    __m128i h = _mm256_cvtps_ph(_mm256_loadu_ps(s + i),
                                _MM_FROUND_TO_NEAREST_INT | _MM_FROUND_NO_EXC);
    _mm_storeu_si128((__m128i *)(d + i), h);
  }
  for (; i < n; ++i) d[i] = f32_to_f16_rne(s[i]);
}

inline void decode_f16_bulk(float *d, const uint16_t *s, size_t n) {
  size_t i = 0;
  for (; i + 8 <= n; i += 8) {
    _mm256_storeu_ps(d + i,
                     _mm256_cvtph_ps(_mm_loadu_si128((const __m128i *)(s + i))));
  }
  for (; i < n; ++i) d[i] = half_to_float(s[i]);
}

template <typename VOp, typename SOp>
int decode_acc_f16(float *a, const uint16_t *s, size_t n, VOp vop, SOp sop) {
  size_t i = 0;
  for (; i + 8 <= n; i += 8) {
    __m256 inc = _mm256_cvtph_ps(_mm_loadu_si128((const __m128i *)(s + i)));
    _mm256_storeu_ps(a + i, vop(_mm256_loadu_ps(a + i), inc));
  }
  for (; i < n; ++i) a[i] = sop(a[i], half_to_float(s[i]));
  return 0;
}
#endif

}  // namespace

extern "C" int kf_encode_wire(void *dst, const void *src, int64_t count,
                              int32_t wire_dtype) {
  uint16_t *d = (uint16_t *)dst;
  const float *s = (const float *)src;
  size_t n = (size_t)count;
  switch (wire_dtype) {
    case BF16:
      for (size_t i = 0; i < n; ++i) d[i] = float_to_bf16(s[i]);
      return 0;
    case F16:
#if defined(__F16C__)
      encode_f16_bulk(d, s, n);
#else
      for (size_t i = 0; i < n; ++i) d[i] = f32_to_f16_rne(s[i]);
#endif
      return 0;
  }
  return -1;
}

extern "C" int kf_decode_wire(void *dst, const void *src, int64_t count,
                              int32_t wire_dtype) {
  float *d = (float *)dst;
  const uint16_t *s = (const uint16_t *)src;
  size_t n = (size_t)count;
  switch (wire_dtype) {
    case BF16:
      for (size_t i = 0; i < n; ++i) d[i] = bf16_to_float(s[i]);
      return 0;
    case F16:
#if defined(__F16C__)
      decode_f16_bulk(d, s, n);
#else
      for (size_t i = 0; i < n; ++i) d[i] = half_to_float(s[i]);
#endif
      return 0;
  }
  return -1;
}

extern "C" int kf_decode_accumulate(void *acc, const void *src, int64_t count,
                                    int32_t wire_dtype, int32_t op) {
  float *a = (float *)acc;
  const uint16_t *s = (const uint16_t *)src;
  size_t n = (size_t)count;
  switch (wire_dtype) {
    case BF16: return decode_acc<bf16_to_float>(a, s, n, op);
    case F16:
#if defined(__F16C__)
      // NaN caveat: _mm256_min/max_ps pick the SECOND operand on NaN,
      // like the scalar a<b?a:b with NaN on either side picking b via
      // the false branch — gradients are NaN-free by contract anyway
      switch (op) {
        case SUM:
          return decode_acc_f16(a, s, n,
              [](__m256 x, __m256 y) { return _mm256_add_ps(x, y); },
              [](float x, float y) { return x + y; });
        case MIN:
          return decode_acc_f16(a, s, n,
              [](__m256 x, __m256 y) { return _mm256_min_ps(x, y); },
              [](float x, float y) { return x < y ? x : y; });
        case MAX:
          return decode_acc_f16(a, s, n,
              [](__m256 x, __m256 y) { return _mm256_max_ps(x, y); },
              [](float x, float y) { return x > y ? x : y; });
        case PROD:
          return decode_acc_f16(a, s, n,
              [](__m256 x, __m256 y) { return _mm256_mul_ps(x, y); },
              [](float x, float y) { return x * y; });
      }
      return -1;
#else
      return decode_acc<half_to_float>(a, s, n, op);
#endif
  }
  return -1;
}

// --- block-scaled int8/int4 wire codec ---------------------------------
//
// Per-block power-of-two absmax scaling: each `block`-element run of the
// f32 segment gets one f32 scale s = 2^ceil(log2(absmax / Qmax)) (Qmax =
// 127 for int8, 7 for int4), then q = clamp(rint(x * (1/s)), -Qmax, Qmax)
// packed as signed bytes (int8) or two's-complement low-nibble-first
// pairs (int4). The pow2 scale is the idempotency lever: decode s*q is
// EXACT in f32 (power of two times a small integer), and re-encoding a
// decoded block re-derives the identical s and identical q — so graph-
// walk relays and the bcast-root roundtrip stay bit-identical, the same
// contract the 16-bit codec gets for free from dtype narrowing.
//
// Layout of an encoded segment of `count` elements:
//   [ceil(count/block) f32 little-endian scales][payload]
// payload = count bytes (int8) or ceil(count/2) bytes (int4, odd count
// leaves the last high nibble zero). Scales are memcpy'd at arbitrary
// byte offsets — no alignment requirement (segments start anywhere).
//
// Rounding contract: scale derivation is fl(absmax/Qmax) -> frexp ->
// ldexp and quantization is rint (round-to-nearest-even), bit-matching
// the plain twins' torch.frexp / power-of-two / torch.round in base/ops.py.

#include <cmath>

namespace {

inline float q_block_scale(const float *s, size_t n, float qmax) {
  float amax = 0.0f;
  for (size_t i = 0; i < n; ++i) {
    float a = s[i] < 0.0f ? -s[i] : s[i];
    if (a > amax) amax = a;
  }
  if (amax == 0.0f) return 0.0f;
  float t = amax / qmax;
  int e;
  float m = frexpf(t, &e);  // t = m * 2^e, m in [0.5, 1)
  return ldexpf(1.0f, m == 0.5f ? e - 1 : e);  // 2^ceil(log2(t))
}

inline int8_t q_unpack4(const uint8_t *payload, size_t i) {
  uint8_t nib = (uint8_t)((payload[i >> 1] >> ((i & 1) ? 4 : 0)) & 0xFu);
  return (int8_t)(nib >= 8u ? (int)nib - 16 : (int)nib);
}

}  // namespace

extern "C" int kf_encode_wire_q(void *dst, const void *src, int64_t count,
                                int32_t bits, int32_t block) {
  if (count < 0 || block < 1 || (bits != 8 && bits != 4)) return -1;
  const float *s = (const float *)src;
  size_t n = (size_t)count;
  size_t nb = (n + (size_t)block - 1) / (size_t)block;
  uint8_t *scales = (uint8_t *)dst;
  uint8_t *payload = scales + 4 * nb;
  const float qmax = bits == 8 ? 127.0f : 7.0f;
  for (size_t b = 0; b < nb; ++b) {
    size_t lo = b * (size_t)block;
    size_t hi = lo + (size_t)block;
    if (hi > n) hi = n;
    float scale = q_block_scale(s + lo, hi - lo, qmax);
    __builtin_memcpy(scales + 4 * b, &scale, 4);
    float inv = scale == 0.0f ? 0.0f : 1.0f / scale;  // pow2: exact
    for (size_t i = lo; i < hi; ++i) {
      float q = rintf(s[i] * inv);
      if (q > qmax) q = qmax;
      if (q < -qmax) q = -qmax;
      int8_t qi = (int8_t)q;
      if (bits == 8) {
        payload[i] = (uint8_t)qi;
      } else if (i & 1) {
        payload[i >> 1] = (uint8_t)(payload[i >> 1] | (((uint8_t)qi & 0xFu) << 4));
      } else {
        payload[i >> 1] = (uint8_t)((uint8_t)qi & 0xFu);
      }
    }
  }
  return 0;
}

extern "C" int kf_decode_wire_q(void *dst, const void *src, int64_t count,
                                int32_t bits, int32_t block) {
  if (count < 0 || block < 1 || (bits != 8 && bits != 4)) return -1;
  float *d = (float *)dst;
  size_t n = (size_t)count;
  size_t nb = (n + (size_t)block - 1) / (size_t)block;
  const uint8_t *scales = (const uint8_t *)src;
  const uint8_t *payload = scales + 4 * nb;
  for (size_t b = 0; b < nb; ++b) {
    size_t lo = b * (size_t)block;
    size_t hi = lo + (size_t)block;
    if (hi > n) hi = n;
    float scale;
    __builtin_memcpy(&scale, scales + 4 * b, 4);
    if (bits == 8) {
      for (size_t i = lo; i < hi; ++i) d[i] = scale * (float)(int8_t)payload[i];
    } else {
      for (size_t i = lo; i < hi; ++i) d[i] = scale * (float)q_unpack4(payload, i);
    }
  }
  return 0;
}

extern "C" int kf_decode_accumulate_q(void *acc, const void *src, int64_t count,
                                      int32_t bits, int32_t block, int32_t op) {
  if (count < 0 || block < 1 || (bits != 8 && bits != 4)) return -1;
  float *a = (float *)acc;
  size_t n = (size_t)count;
  size_t nb = (n + (size_t)block - 1) / (size_t)block;
  const uint8_t *scales = (const uint8_t *)src;
  const uint8_t *payload = scales + 4 * nb;
  for (size_t b = 0; b < nb; ++b) {
    size_t lo = b * (size_t)block;
    size_t hi = lo + (size_t)block;
    if (hi > n) hi = n;
    float scale;
    __builtin_memcpy(&scale, scales + 4 * b, 4);
    for (size_t i = lo; i < hi; ++i) {
      float v = scale * (float)(bits == 8 ? (int8_t)payload[i]
                                          : q_unpack4(payload, i));
      switch (op) {
        case SUM:  a[i] += v; break;
        case MIN:  a[i] = a[i] < v ? a[i] : v; break;
        case MAX:  a[i] = a[i] > v ? a[i] : v; break;
        case PROD: a[i] *= v; break;
        default: return -1;
      }
    }
  }
  return 0;
}
