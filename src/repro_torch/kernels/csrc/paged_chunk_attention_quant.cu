// Chunked mixed-step attention over a quantized paged KV cache (int8 or
// fp8-e4m3 pools with one f32 scale per pool row), the span's quantizing
// write fused in the same call.  Replaces the TPU kernel
// src/repro/kernels/paged_chunk_attention.py · paged_chunk_attention_quant
// (pl.pallas_call at :389, kernel body _mha_kernel_quant at :210): quantize
// the span's K/V rows into slots start..start+span-1 through the block
// table, then causal (optionally windowed) GQA attention of each span query
// j over start+j+1 dequantized keys.
//
// Bound on the H100: bytes.  The walk reads each live K and V row once at
// one byte per value plus 4 bytes of scale; the scores are D FMAs per key
// per query row, far below the card's ridge at the mixed steps' spans.
//
// Design: write_tokens_quant scatters and quantizes the span first (its own
// launch, so every key a query may read is resident before any block reads
// it, and a -1 entry reads page 0 as the plain version does; pools and
// scales bitwise the plain version's).  Then the tensor-core walk
// attend_mma::chunk_mma (attend_mma.cuh: one block a (row, KV head)
// walking its live query rows 64 at a time, raw int8/e4m3 K/V tiles by
// cp.async in a three-stage ring, mma.sync bf16 with the row scales
// outside the MMA).  No atomics.
//
// ptxas -v (sm_90a, -O3; build.FLAGS passes it): see PERF.md's kernel
// table, row 5.
#include "attend_mma.cuh"

// dtype: q/out, kvdtype: k/v_new, each 0 = float32, 1 = bfloat16; qdtype:
// pools 0 = int8, 1 = fp8-e4m3.  k/v_new are [B, Hkv, C, D]; scales
// float32 [P, Hkv, ps]; part: float32 scratch of B·Hkv·nsplit·C·(Hq/Hkv)·
// (D + 2) (null when nsplit is 1); the key split (nsplit ranges of
// split_len keys) is paged_chunk_attention_quant.py · split_plan's.
// Returns cudaGetLastError() after the launches (0 on success),
// cudaErrorInvalidValue for an unsupported dtype or head_dim.
extern "C" int paged_chunk_attention_quant(
    int dtype, int kvdtype, int qdtype, const void* q, void* out,
    void* k_pages, void* v_pages, float* k_scales, float* v_scales,
    const void* k_new, const void* v_new, const int* block_tables,
    const int* start, const int* span, float* part, int b, int hq, int hkv,
    int c, int d, int ps, int maxp, float scale, int window, int nsplit,
    int split_len, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b == 0 || c == 0) return 0;
  const int err = rt::write_quant(kvdtype, qdtype, k_pages, v_pages,
                                  k_scales, v_scales, k_new, v_new,
                                  block_tables, start, span, b, c, d, hkv, ps,
                                  maxp, s);
  if (err) return err;
#define RT_CALL(T, C)                                                       \
  attend_mma::attend<T, attend_mma::CodePool<C>>(                          \
      q, out, k_pages, v_pages, k_scales, v_scales, block_tables, start,    \
      span, part, b, hq, hkv, c, d, ps, maxp, scale, window, nsplit,        \
      split_len, s)
  RT_DISPATCH_QUANT(dtype, qdtype, RT_CALL);
#undef RT_CALL
}
