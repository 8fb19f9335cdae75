// Chunked mixed-step MLA over a paged latent cache, the span's latent-row
// write fused in the same call.  Replaces the TPU kernel
// src/repro/kernels/paged_chunk_attention.py · paged_mla_chunk
// (pl.pallas_call at :531): write the span's rows concat([ckv; krope])
// into slots start..start+span-1 through the block table, then every head's
// span query j scores the row's start+j+1 latent rows over their r + rd
// live features (q = concat(q_abs, q_rope), float32) and takes
// softmax·ckv, r wide, as its float32 context.
//
// Bound on the H100: at the serving shapes (16 heads, spans up to 64)
// every latent row read serves 16·span query rows at 2·(L + r) FLOPs
// each, so prompt chunks sit near or above the card's ridge and decode
// rows below it; chip_smoke.py computes which from the run's own spans.
// The scores here are float32 FMAs from shared memory (no tensor cores):
// a kernel that keeps q in float32 reaches at most TF32's share of the
// bf16 peak.
//
// Design: write_latent copies the span's Dp-wide rows first (its own
// launch, so every row a query may read is resident before any block
// reads it, and a -1 entry reads page 0 as the plain version does).  Then
// one block per (batch row, tile of 16 of the H·C query rows) walks the
// row's latent rows 32 at a time: each row is loaded once into shared
// memory and serves as the key (L features) and the value (its first r)
// of all 16 query rows.  Blocks whose rows all lie past the span write
// zeros and read no rows.  Dynamic shared memory (113 KB at L = 576).
#include "mla_common.cuh"

// dtype: pool and latent_new 0 = float32, 1 = bfloat16.  q is float32
// [B, H, C, r+rd], ctx float32 [B, H, C, r], latent_new [B, C, dp].
// Returns cudaGetLastError() after the launches (0 on success),
// cudaErrorInvalidValue for an unsupported dtype or r > 512.
extern "C" int paged_mla_chunk(int dtype, const float* q, float* ctx,
                               void* latent_pages, const void* latent_new,
                               const int* block_tables, const int* start,
                               const int* span, int b, int h, int c, int r,
                               int rd, int dp, int ps, int maxp, float scale,
                               void* stream) {
  return mla::run_float(dtype, q, ctx, latent_pages, latent_new,
                        block_tables, start, span, b, h, c, r, rd, dp, ps,
                        maxp, scale, static_cast<cudaStream_t>(stream));
}
