// Single-token MLA decode over a quantized paged latent cache (int8 or
// fp8-e4m3 pool with one f32 scale per latent row), the token's
// quantizing write fused in the same call.  Replaces the TPU kernel
// src/repro/kernels/paged_mla_decode.py · paged_mla_decode_quant
// (pl.pallas_call at :270): quantize the token's Dp-wide row into slot pos
// (its scale into [P, ps]), then the attend of paged_mla_decode over the
// dequantized rows.
//
// Bound on the H100: bytes — each batch row reads its pos+1 rows once at
// one byte per value plus 4 bytes of scale, far below the card's ridge.
//
// Design: write_latent_quant (one warp per row, bitwise the plain
// version's quantize_rows; quant_common.cuh) as its own launch, then the
// walk of paged_mla_decode — grid (B, H/16), 32 rows per tile, each row
// dequantized once into the float32 shared tile and used as key and value
// by 16 heads.  Split-KV is a later, measured change.
#include "mla_common.cuh"

// kvdtype: latent_new 0 = float32, 1 = bfloat16; qdtype: pool 0 = int8,
// 1 = fp8-e4m3.  q float32 [B, H, r+rd], ctx float32 [B, H, r],
// latent_new [B, dp], scales float32 [P, ps], pos i32[B] (< maxp*ps).
// Returns cudaGetLastError() after the launches (0 on success),
// cudaErrorInvalidValue for an unsupported dtype or r > 512.
extern "C" int paged_mla_decode_quant(int kvdtype, int qdtype,
                                      const float* q, float* ctx,
                                      void* latent_pages,
                                      float* latent_scales,
                                      const void* latent_new,
                                      const int* block_tables,
                                      const int* pos, int b, int h, int r,
                                      int rd, int dp, int ps, int maxp,
                                      float scale, void* stream) {
  return mla::run_quant(kvdtype, qdtype, q, ctx, latent_pages, latent_scales,
                        latent_new, block_tables, pos, nullptr, b, h, 1, r,
                        rd, dp, ps, maxp, scale,
                        static_cast<cudaStream_t>(stream));
}
