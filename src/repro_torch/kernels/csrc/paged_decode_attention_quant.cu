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
// Design: a decode call is paged_chunk_attention_quant's with span 1 at
// pos.  write_tokens_quant (one warp per K or V row: abs-max by warp
// reduction, IEEE division, rint/clamp or the SATFINITE e4m3 conversion)
// runs first, its own launch, so the pools and scales it leaves are
// bitwise the plain version's and every key is resident before the walk
// reads it.  Then the tensor-core walk attend_mma::chunk_mma with the
// CodePool policy in its decode form (span == nullptr, start = pos): raw
// int8 / e4m3 tiles by cp.async, converted once to bf16, the row scales
// outside the MMA, P·V on p·s_v in two bf16 terms (bf16 q) or three
// (float32 q, with q in three), the row's keys split over nsplit blocks
// (paged_chunk_attention_quant.py · decode_split_plan) and merged by
// chunk_combine.  No atomics: every run gives the same bits.
//
// ptxas -v (sm_90a, -O3; build.FLAGS passes it): see PERF.md's kernel
// table, row 4.
#include "attend_mma.cuh"

// dtype: q/out, kvdtype: k/v_new, each 0 = float32, 1 = bfloat16; qdtype:
// pools 0 = int8, 1 = fp8-e4m3.  k/v_new are [B, Hkv, D]; scales float32
// [P, Hkv, ps]; part: float32 scratch of B·Hkv·nsplit·(Hq/Hkv)·(D + 2)
// (null when nsplit is 1); the key split (nsplit ranges of split_len keys)
// is paged_chunk_attention_quant.py · decode_split_plan's.  Returns
// cudaGetLastError() after the launches (0 on success),
// cudaErrorInvalidValue for an unsupported dtype or head_dim.
extern "C" int paged_decode_attention_quant(
    int dtype, int kvdtype, int qdtype, const void* q, void* out,
    void* k_pages, void* v_pages, float* k_scales, float* v_scales,
    const void* k_new, const void* v_new, const int* block_tables,
    const int* pos, float* part, int b, int hq, int hkv, int d, int ps,
    int maxp, float scale, int window, int nsplit, int split_len,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b == 0) return 0;
  const int err = rt::write_quant(kvdtype, qdtype, k_pages, v_pages,
                                  k_scales, v_scales, k_new, v_new,
                                  block_tables, pos, nullptr, b, 1, d, hkv,
                                  ps, maxp, s);
  if (err) return err;
#define RT_CALL(T, C)                                                       \
  attend_mma::attend<T, attend_mma::CodePool<C>>(                          \
      q, out, k_pages, v_pages, k_scales, v_scales, block_tables, pos,      \
      nullptr, part, b, hq, hkv, 1, d, ps, maxp, scale, window, nsplit,     \
      split_len, s)
  RT_DISPATCH_QUANT(dtype, qdtype, RT_CALL);
#undef RT_CALL
}
