// Chunked mixed-step MLA over a quantized paged latent cache (int8 or
// fp8-e4m3 pool with one f32 scale per latent row), the span's quantizing
// write fused in the same call.  Replaces the TPU kernel
// src/repro/kernels/paged_chunk_attention.py · paged_mla_chunk_quant
// (pl.pallas_call at :695): quantize the span's Dp-wide rows into slots
// start..start+span-1 (scales into [P, ps]), then the attend of
// paged_mla_chunk over the dequantized rows.
//
// Bound on the H100: as paged_mla_chunk, at one byte per cached value
// plus 4 bytes of scale per row.
//
// Design: write_latent_quant runs first — one warp per row, abs-max over
// the whole Dp row by warp reduction, the explicit float32 reciprocal,
// IEEE division, rint/clamp or the SATFINITE e4m3 conversion
// (quant_common.cuh) — so pool bytes and scales are bitwise the plain
// version's.  Then the walk of paged_mla_chunk with a loader that
// dequantizes each 16-byte load (16 values) by its row's scale into the
// float32 shared tile, the product dequantize_rows forms: only the
// summation order differs from the plain version.  No atomics.
#include "mla_common.cuh"

// kvdtype: latent_new 0 = float32, 1 = bfloat16; qdtype: pool 0 = int8,
// 1 = fp8-e4m3.  q float32 [B, H, C, r+rd], ctx float32 [B, H, C, r],
// latent_new [B, C, dp], scales float32 [P, ps].  Returns
// cudaGetLastError() after the launches (0 on success),
// cudaErrorInvalidValue for an unsupported dtype or r > 512.
extern "C" int paged_mla_chunk_quant(int kvdtype, int qdtype, const float* q,
                                     float* ctx, void* latent_pages,
                                     float* latent_scales,
                                     const void* latent_new,
                                     const int* block_tables,
                                     const int* start, const int* span,
                                     int b, int h, int c, int r, int rd,
                                     int dp, int ps, int maxp, float scale,
                                     void* stream) {
  return mla::run_quant(kvdtype, qdtype, q, ctx, latent_pages, latent_scales,
                        latent_new, block_tables, start, span, b, h, c, r,
                        rd, dp, ps, maxp, scale,
                        static_cast<cudaStream_t>(stream));
}
