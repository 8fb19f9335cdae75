// Inline-PTX pieces of the tensor-core kernels (sm_90a): cp.async copies
// into shared memory, ldmatrix, mma.sync m16n8k16 bf16 -> f32, bf16
// packing and the quad reductions of an mma row.  flash_attention.cu
// (flash_fwd_mma) and the two quantized chunk walks (mla_mma.cuh,
// attend_mma.cuh) use them.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; !in fills the 16 bytes with
// zeros and reads nothing (src-size 0).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0));
}
// 4 bytes global -> shared (a row scale), zero-filled where !in.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8 × 8 b16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, and r[i] is its fragment (lane l: row l/4, columns 2(l%4),
// 2(l%4)+1; with .trans the transposed matrix's).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a · b for a 16 × 16 bf16 A (row major), a 16 × 8 bf16 B (column
// major) and a 16 × 8 float32 C.  With g = lane/4, j = lane%4: a[0..3]
// hold A[g][2j..], A[g+8][2j..], A[g][2j+8..], A[g+8][2j+8..]; b0, b1
// hold B[2j..][g], B[2j+8..][g]; c holds C[g][2j], C[g][2j+1],
// C[g+8][2j], C[g+8][2j+1].
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as a bf16 pair, round to nearest even; lo in the low half
// (the lower column of an mma fragment).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// x as N bf16 terms whose float sum is x to within 2^-(8N+1)·|x| (round
// to nearest each; every remainder x - sum is exact in float32): N = 1 is
// x rounded to bf16, N = 3 holds a float32 value in effect.
template <int N>
__device__ __forceinline__ void split_bf16(float x, __nv_bfloat16 (&t)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    t[i] = __float2bfloat16_rn(x);
    x -= __bfloat162float(t[i]);
  }
}

// Two floats as N bf16-pair terms by truncation: each term keeps the upper
// 16 bits of what is left (a logic op, exact remainder), so N = 3 holds 24
// significant bits: float32 in effect, without conversion instructions.
template <int N>
__device__ __forceinline__ void split_trunc(float lo, float hi,
                                            uint32_t (&t)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const uint32_t a = __float_as_uint(lo) & 0xffff0000u;
    const uint32_t b = __float_as_uint(hi) & 0xffff0000u;
    t[i] = __byte_perm(a, b, 0x7632);
    lo -= __uint_as_float(a);
    hi -= __uint_as_float(b);
  }
}

}  // namespace tc
