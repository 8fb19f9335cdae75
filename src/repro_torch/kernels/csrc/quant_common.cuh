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
  __device__ __forceinline__ static float dequant(S v) {
    return static_cast<float>(v);
  }
};

struct Fp8Codec {
  using S = uint8_t;  // e4m3 bits
  static constexpr float QMAX = 448.f;
  __device__ __forceinline__ static S quant(float q) {
    return static_cast<S>(__nv_cvt_float_to_fp8(q, __NV_SATFINITE, __NV_E4M3));
  }
  __device__ __forceinline__ static float dequant(S v) {
    const __half_raw h = __nv_cvt_fp8_to_halfraw(
        static_cast<__nv_fp8_storage_t>(v), __NV_E4M3);
    return __half2float(__half(h));
  }
};

// Loader of a quantized paged pool for attend_kv(): one 16-byte load of
// K and of V per (key, chunk), each value times its row's scale.
template <class Codec>
struct QuantKV {
  using S = typename Codec::S;
  static constexpr int VEC = 16;  // one-byte elements per 16-byte load
  const S* __restrict__ kpool;
  const S* __restrict__ vpool;
  const float* __restrict__ kscale;
  const float* __restrict__ vscale;
  PagedKeys keys;
  __device__ __forceinline__ void load(int t, int part, float* kd,
                                       float* vd) const {
    const size_t r = keys.row(t);
    const size_t o = r * keys.d + part * VEC;
    const float sk = kscale[r], sv = vscale[r];
    const uint4 kraw = *reinterpret_cast<const uint4*>(kpool + o);
    const uint4 vraw = *reinterpret_cast<const uint4*>(vpool + o);
    const S* ke = reinterpret_cast<const S*>(&kraw);
    const S* ve = reinterpret_cast<const S*>(&vraw);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      kd[e] = Codec::dequant(ke[e]) * sk;
      vd[e] = Codec::dequant(ve[e]) * sv;
    }
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

// The quantizing write, as its own launch before the walk: grid (B, Hkv),
// one warp per (token, K or V) row.  Token j < span[b] of row b (span ==
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
  for (int i = warp; i < 2 * sp; i += NT / 32) {
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
  write_tokens_quant<KT, Codec><<<dim3(b, hkv), NT, 0, stream>>>(
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
