// Chunked mixed-step MLA over a quantized paged latent cache (int8 or
// fp8-e4m3 pool with one f32 scale per latent row), the span's quantizing
// write fused in the same call.  Replaces the TPU kernel
// src/repro/kernels/paged_chunk_attention.py · paged_mla_chunk_quant
// (pl.pallas_call at :695): quantize the span's Dp-wide rows into slots
// start..start+span-1 (scales into [P, ps]), then the attend of
// paged_mla_chunk over the dequantized rows.
//
// Bound on the H100: bytes, at one byte per cached value plus 4 bytes of
// scale per row; the work is 2·(2r + rd) FLOPs a (head, attended row),
// 3.6 GFLOP at the kernel phase's spans, which float32 FMAs could not keep
// up with (the FMA walk this replaces took 1.195 ms against a byte bound
// of 0.0056 ms on the H100, PERF.md).
//
// Design: write_latent_quant (mla_common.cuh) runs first — one warp per
// row, abs-max over the whole Dp row by warp reduction, the explicit
// float32 reciprocal, IEEE division, rint/clamp or the SATFINITE e4m3
// conversion (quant_common.cuh) — so pool bytes and scales are bitwise the
// plain version's.  Then the tensor-core walk mla_mma::walk (mla_mma.cuh:
// heads inner, raw int8/e4m3 tiles by cp.async, q read in place as three
// bf16 terms and P·s in three, the keys split over blocks by a plan from
// shapes, a float32 combine).  No atomics.
//
// ptxas -v (sm_90a, -O3; build.FLAGS passes it): see PERF.md's kernel
// table, row 7.
#include "mla_common.cuh"
#include "mla_mma.cuh"

// kvdtype: latent_new 0 = float32, 1 = bfloat16; qdtype: pool 0 = int8,
// 1 = fp8-e4m3; qrdtype: q_rope 0 = float32, 1 = bfloat16.  q_abs float32
// [B, H, C, r], q_rope [B, H, C, rd], both 16-byte aligned; ctx float32
// [B, H, C, r], latent_new [B, C, dp], scales float32 [P, ps]; part:
// float32 scratch of B·max(2·ceil(C·H / 16), nsplit)·16·(r + 2) (null when
// nsplit is 1); a row splits its keys into at most nsplit runs of at least
// min_len keys (paged_mla_chunk_quant.py · split_plan).
// Returns cudaGetLastError() after the launches (0 on success),
// cudaErrorInvalidValue for an unsupported dtype or r > 512.
extern "C" int paged_mla_chunk_quant(int kvdtype, int qdtype, int qrdtype,
                                     const float* q_abs, const void* q_rope,
                                     float* ctx, void* latent_pages,
                                     float* latent_scales,
                                     const void* latent_new,
                                     const int* block_tables,
                                     const int* start, const int* span,
                                     float* part, int b, int h, int c, int r,
                                     int rd, int dp, int ps, int maxp,
                                     int nsplit, int min_len, float scale,
                                     void* stream) {
#define MLA_RUN(IT, C)                                                     \
  mla_mma::run<mla_mma::CodePool<C>, IT>(                                  \
      q_abs, q_rope, qrdtype, ctx, latent_pages, latent_scales, latent_new, \
      block_tables, start, span, part, b, h, c, r, rd, dp, ps, maxp,        \
      nsplit, min_len, scale, static_cast<cudaStream_t>(stream))
  RT_DISPATCH_QUANT(kvdtype, qdtype, MLA_RUN);
#undef MLA_RUN
}
