// Single-token decode over a quantized paged KV cache (int8 or fp8-e4m3
// pools with one f32 scale per pool row), the token's quantizing write
// fused in the same call.  Replaces the TPU kernel
// src/repro/kernels/paged_decode_attention.py · paged_decode_attention_quant
// (pl.pallas_call at :355, kernel body _kernel_quant at :193): quantize the
// token's K/V rows into slot pos through the block table, then attend over
// pos+1 dequantized keys, sliding window optional.
//
// Bound on the H100: bytes.  Each (row, KV head) reads its live K and V
// rows once at one byte per value plus 4 bytes of scale per row — about
// half the bf16 kernel's traffic — for 2·D FLOPs per key and query head.
//
// Design: write_tokens_quant (one warp per K or V row: abs-max by warp
// reduction, IEEE division, rint/clamp or the SATFINITE e4m3 conversion)
// runs first, so the pools and scales it leaves are bitwise the plain
// version's.  Then the walk of paged_decode_attention with a loader that
// dequantizes each 16-byte load (16 values) by its row's scale into the
// float32 shared tile — the same product dequantize_rows forms, so only the
// summation order differs from the plain version.  No atomics: every run
// gives the same bits.
#include "quant_common.cuh"

namespace {

template <typename T, class Codec, int D>
__global__ void __launch_bounds__(rt::NT)
    decode_attend_quant(const T* __restrict__ q, T* __restrict__ out,
                        const typename Codec::S* __restrict__ kp,
                        const typename Codec::S* __restrict__ vp,
                        const float* __restrict__ ks,
                        const float* __restrict__ vs,
                        const int* __restrict__ bt,
                        const int* __restrict__ pos, int hq, int hkv, int ps,
                        int maxp, float scale, int window) {
  const int b = blockIdx.x, h = blockIdx.y;
  const int group = hq / hkv;
  const int g0 = blockIdx.z * rt::QR;
  const int nrows = min(rt::QR, group - g0);
  __shared__ rt::RowSet rows;
  if (threadIdx.x < nrows) {
    rows.off[threadIdx.x] =
        (static_cast<long long>(b) * hq + h * group + g0 + threadIdx.x) * D;
    rows.pos[threadIdx.x] = pos[b];
    rows.on[threadIdx.x] = 1;
  }
  __syncthreads();
  const rt::PagedKeys keys{bt + static_cast<size_t>(b) * maxp, hkv, h, ps, D};
  const rt::QuantKV<Codec> kv{kp, vp, ks, vs, keys};
  rt::attend_kv<T, D>(q, out, kv, rows, nrows, maxp * ps, scale, window);
}

template <typename T, class Codec>
int launch(const void* q, void* out, const void* kp, const void* vp,
           const float* ks, const float* vs, const int* bt, const int* pos,
           int b, int hq, int hkv, int d, int ps, int maxp, float scale,
           int window, cudaStream_t stream) {
  using S = typename Codec::S;
  const dim3 grid(b, hkv, (hq / hkv + rt::QR - 1) / rt::QR);
  RT_DISPATCH_D(d, decode_attend_quant<T, Codec, HD><<<grid, rt::NT, 0,
                                                       stream>>>(
                       static_cast<const T*>(q), static_cast<T*>(out),
                       static_cast<const S*>(kp), static_cast<const S*>(vp),
                       ks, vs, bt, pos, hq, hkv, ps, maxp, scale, window));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: q/out, kvdtype: k/v_new, each 0 = float32, 1 = bfloat16; qdtype:
// pools 0 = int8, 1 = fp8-e4m3.  k/v_new are [B, Hkv, D]; scales float32
// [P, Hkv, ps].  Returns cudaGetLastError() after the launches (0 on
// success), cudaErrorInvalidValue for an unsupported dtype or head_dim.
extern "C" int paged_decode_attention_quant(
    int dtype, int kvdtype, int qdtype, const void* q, void* out,
    void* k_pages, void* v_pages, float* k_scales, float* v_scales,
    const void* k_new, const void* v_new, const int* block_tables,
    const int* pos, int b, int hq, int hkv, int d, int ps, int maxp,
    float scale, int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b == 0) return 0;
  const int err = rt::write_quant(kvdtype, qdtype, k_pages, v_pages,
                                  k_scales, v_scales, k_new, v_new,
                                  block_tables, pos, nullptr, b, 1, d, hkv,
                                  ps, maxp, s);
  if (err) return err;
#define RT_CALL(T, C)                                                     \
  launch<T, C>(q, out, k_pages, v_pages, k_scales, v_scales, block_tables, \
               pos, b, hq, hkv, d, ps, maxp, scale, window, s)
  RT_DISPATCH_QUANT(dtype, qdtype, RT_CALL);
#undef RT_CALL
}
