// Shared pieces of the two quantized-pool attention kernels (sm_90a).
//
// A quantized page pool stores each pool row (page, KV head, slot) as D
// int8 or fp8-e4m3 values plus one f32 scale in a [P, Hkv, ps] scale pool.
// The codecs below are the plain version's quantize_rows / dequantize_rows
// (kernels/ref.py) step for step, so pool bytes and scales come out equal
// bit for bit (no fast-math: the division must be IEEE round-to-nearest):
//   amax  = max |x| over the row (float32)
//   scale = amax > 0 ? amax * (1/qmax) : 1     (explicit reciprocal)
//   q     = x / scale,  int8: rint (half to even), clamp to +-127
//                       fp8:  round to nearest even, saturate to +-448
//   read  = float(q) * scale
#pragma once

#include <cuda_fp8.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace rt {

struct Int8Codec {
  using S = int8_t;
  static constexpr float QMAX = 127.f;
  __device__ __forceinline__ static S quant(float q) {
    return static_cast<S>(fminf(fmaxf(rintf(q), -QMAX), QMAX));
  }
  // Four codes (byte i of w) as two bf16 pairs, exactly, in full-rate ALU
  // operations (no conversion instruction): 2^23 + 128 + v as a float by
  // byte permutes, less 2^23 + 128, is v; |v| <= 128 has at most 8
  // significant bits, so its bf16 is the float's upper half.  lo holds
  // codes 0, 1 (code 0 in the low half), hi codes 2, 3: the B fragments of
  // the tensor-core walks.
  __device__ __forceinline__ static void quad_bf16(uint32_t w, uint32_t& lo,
                                                   uint32_t& hi) {
    const uint32_t u = w ^ 0x80808080u;          // codes + 128, as bytes
    float f[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + i)) -
             8388736.f;
    lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
    hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
  }
};

struct Fp8Codec {
  using S = uint8_t;  // e4m3 bits
  static constexpr float QMAX = 448.f;
  __device__ __forceinline__ static S quant(float q) {
    return static_cast<S>(__nv_cvt_float_to_fp8(q, __NV_SATFINITE, __NV_E4M3));
  }
  // Four codes (byte i of w) as two bf16 pairs (see Int8Codec), exactly,
  // in full-rate ALU operations: the sign and the 7 exponent / mantissa
  // bits placed under a float's sign and exponent make the code's value
  // times 2^-120 (subnormal codes included: float keeps denormals), and
  // the product with 2^120 is exact; 4 significant bits fit bf16.  The
  // NaN codes 0x7f / 0xff give +-480 (quantize_rows never writes them).
  __device__ __forceinline__ static void quad_bf16(uint32_t w, uint32_t& lo,
                                                   uint32_t& hi) {
    const float f0 = __uint_as_float(((w & 0x80u) << 24) |
                                     ((w & 0x7fu) << 20)) * 0x1p120f;
    const float f1 = __uint_as_float(((w & 0x8000u) << 16) |
                                     ((w & 0x7f00u) << 12)) * 0x1p120f;
    const float f2 = __uint_as_float(((w & 0x800000u) << 8) |
                                     ((w & 0x7f0000u) << 4)) * 0x1p120f;
    const float f3 = __uint_as_float((w & 0x80000000u) |
                                     ((w & 0x7f000000u) >> 4)) * 0x1p120f;
    lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
    hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
  }
};

// Quantize one row of d values (src, float32 or bf16: widened to float32
// in registers, which is exact) into pool row ``dst`` of pool / scales,
// one warp per row: lanes stride the row, the abs-max is a warp
// reduction, lane 0 writes the scale.
template <class Codec, typename KT>
__device__ __forceinline__ void quantize_row(typename Codec::S* pool,
                                             float* scales,
                                             const KT* __restrict__ src,
                                             size_t dst, int d, int lane) {
  float amax = 0.f;
  for (int e = lane; e < d; e += 32) amax = fmaxf(amax, fabsf(to_f(src[e])));
  amax = warp_max(amax);
  const float scale = amax > 0.f ? amax * (1.0f / Codec::QMAX) : 1.0f;
  for (int e = lane; e < d; e += 32)
    pool[dst * d + e] = Codec::quant(__fdiv_rn(to_f(src[e]), scale));
  if (lane == 0) scales[dst] = scale;
}

// The quantizing write, as its own launch before the walk: grid (B, Hkv,
// Z), one warp per (token, K or V) row, the span's 2·span rows spread over
// the Z blocks of a (row, head).  Token j < span[b] of row b (span ==
// nullptr: one token at start[b]) lands in page bt[b, (start+j)/ps] slot
// (start+j)%ps; -1 pages and positions past the table drop.  k/v_new are
// KT (float32 or bf16) [B, Hkv, c, D].
template <typename KT, class Codec>
__global__ void __launch_bounds__(NT)
    write_tokens_quant(typename Codec::S* __restrict__ kp,
                       typename Codec::S* __restrict__ vp,
                       float* __restrict__ ks, float* __restrict__ vs,
                       const KT* __restrict__ kn,
                       const KT* __restrict__ vn,
                       const int* __restrict__ bt,
                       const int* __restrict__ start,
                       const int* __restrict__ span, int c, int d, int hkv,
                       int ps, int maxp) {
  const int b = blockIdx.x, h = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int st = start[b];
  const int sp = span == nullptr ? 1 : span[b];
  for (int i = blockIdx.z * (NT / 32) + warp; i < 2 * sp;
       i += gridDim.z * (NT / 32)) {
    const int j = i >> 1, t = st + j;
    if (t >= maxp * ps) continue;           // warp-uniform
    const int page = bt[b * maxp + t / ps];
    if (page < 0) continue;
    const size_t dst = (static_cast<size_t>(page) * hkv + h) * ps + t % ps;
    const size_t src = ((static_cast<size_t>(b) * hkv + h) * c + j) * d;
    if (i & 1)
      quantize_row<Codec>(vp, vs, vn + src, dst, d, lane);
    else
      quantize_row<Codec>(kp, ks, kn + src, dst, d, lane);
  }
}

}  // namespace rt

// Dispatch a float dtype (0 = float32, 1 = bfloat16) and the pool's (0 =
// int8, 1 = fp8-e4m3) onto a templated call CALL(T, Codec).
#define RT_DISPATCH_QUANT(DTYPE, QDTYPE, CALL)                           \
  do {                                                                   \
    if ((DTYPE) == 0 && (QDTYPE) == 0) return CALL(float, rt::Int8Codec);\
    if ((DTYPE) == 0 && (QDTYPE) == 1) return CALL(float, rt::Fp8Codec); \
    if ((DTYPE) == 1 && (QDTYPE) == 0)                                   \
      return CALL(__nv_bfloat16, rt::Int8Codec);                         \
    if ((DTYPE) == 1 && (QDTYPE) == 1)                                   \
      return CALL(__nv_bfloat16, rt::Fp8Codec);                          \
    return static_cast<int>(cudaErrorInvalidValue);                      \
  } while (0)

namespace rt {

template <typename KT, class Codec>
int launch_write_quant(void* kp, void* vp, float* ks, float* vs,
                       const void* kn, const void* vn, const int* bt,
                       const int* start, const int* span, int b, int c,
                       int d, int hkv, int ps, int maxp,
                       cudaStream_t stream) {
  using S = typename Codec::S;
  write_tokens_quant<KT, Codec>
      <<<dim3(b, hkv, (2 * c + NT / 32 - 1) / (NT / 32)), NT, 0, stream>>>(
      static_cast<S*>(kp), static_cast<S*>(vp), ks, vs,
      static_cast<const KT*>(kn), static_cast<const KT*>(vn), bt, start, span,
      c, d, hkv, ps, maxp);
  return static_cast<int>(cudaGetLastError());
}

// The quantizing write of k/v_new (dtype code kvdtype) into pools of code
// qdtype; returns the launch's CUDA status.
inline int write_quant(int kvdtype, int qdtype, void* kp, void* vp,
                       float* ks, float* vs, const void* kn, const void* vn,
                       const int* bt, const int* start, const int* span,
                       int b, int c, int d, int hkv, int ps, int maxp,
                       cudaStream_t stream) {
#define RT_WRITE(KT, C)                                                     \
  launch_write_quant<KT, C>(kp, vp, ks, vs, kn, vn, bt, start, span, b, c, \
                            d, hkv, ps, maxp, stream)
  RT_DISPATCH_QUANT(kvdtype, qdtype, RT_WRITE);
#undef RT_WRITE
}

}  // namespace rt
