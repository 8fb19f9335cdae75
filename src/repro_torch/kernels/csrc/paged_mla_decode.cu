// Single-token MLA decode over a paged latent cache, the token's
// latent-row write fused in the same call.  Replaces the TPU kernel
// src/repro/kernels/paged_mla_decode.py · paged_mla_decode
// (pl.pallas_call at :136): write the token's row concat([ckv; krope])
// at slot pos through the block table, then every head's query scores
// the row's pos+1 latent rows over their r + rd live features and takes
// softmax·ckv, r wide, as its float32 context.
//
// Bound on the H100: bytes.  Each batch row reads its pos+1 latent rows
// once (L values each) for 16 query heads at 2·(L + r) FLOPs per head
// and row, far below the card's ridge.
//
// Design: write_latent first (its own launch: the walk reads a fully
// written pool, a -1 entry reads page 0 as in the plain version), then
// the walk of paged_mla_chunk with one query per head: one block per
// (batch row, tile of 16 heads), 32 latent rows per tile, each row loaded
// once and used as key and value by all 16 heads.  The grid is
// (B, H/16): 8 blocks at the serving shapes, so long rows are walked by
// one block each — splitting the walk across blocks (split-KV) is a later,
// measured change.
#include "mla_common.cuh"

// dtype: pool and latent_new 0 = float32, 1 = bfloat16.  q is float32
// [B, H, r+rd], ctx float32 [B, H, r], latent_new [B, dp], pos i32[B]
// (< maxp*ps).  Returns cudaGetLastError() after the launches (0 on
// success), cudaErrorInvalidValue for an unsupported dtype or r > 512.
extern "C" int paged_mla_decode(int dtype, const float* q, float* ctx,
                                void* latent_pages, const void* latent_new,
                                const int* block_tables, const int* pos,
                                int b, int h, int r, int rd, int dp, int ps,
                                int maxp, float scale, void* stream) {
  return mla::run_float(dtype, q, ctx, latent_pages, latent_new,
                        block_tables, pos, nullptr, b, h, 1, r, rd, dp, ps,
                        maxp, scale, static_cast<cudaStream_t>(stream));
}
