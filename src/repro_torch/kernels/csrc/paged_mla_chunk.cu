// Chunked mixed-step MLA over a paged latent cache, the span's latent-row
// write fused in the same call.  Replaces the TPU kernel
// src/repro/kernels/paged_chunk_attention.py · paged_mla_chunk
// (pl.pallas_call at :531): write the span's rows concat([ckv; krope])
// into slots start..start+span-1 through the block table, then every head's
// span query j scores the row's start+j+1 latent rows over their r + rd
// live features (q = concat(q_abs, q_rope), read in place from its two
// parts) and takes softmax·ckv, r wide, as its float32 context.
//
// Bound on the H100: at the serving shapes (16 heads, spans up to 64)
// every latent row read serves 16·span query rows at 2·(L + r) FLOPs
// each, so prompt chunks sit near or above the card's ridge and decode
// rows below it; chip_smoke.py computes which from the run's own spans.
// The FMA walk this replaces on bf16 pools took 0.973 ms against a byte
// bound of 0.00615 ms on the H100 (PERF.md).
//
// Design: write_latent copies the span's Dp-wide rows first (its own
// launch over (B, ceil(C / 4)) blocks, one warp a row, so every row a
// query may read is resident before any block reads it, and a -1 entry
// reads page 0 as the plain version does; pool bytes bitwise).  Then:
//   - bf16 pool: the tensor-core walk mla_mma::walk with the Bf16Pool
//     policy (mla_mma.cuh: heads inner, one m16 tile a block, bf16 rows by
//     cp.async in natural k order, q read in place as three bf16 terms and
//     P in three, the keys split over blocks by paged_mla_chunk_quant.py ·
//     split_plan, a float32 combine) — the walk of paged_mla_chunk_quant,
//     without the scales.  No atomics.
//   - float32 pool (the CPU-shaped tests' route): the FMA walk mla::attend
//     (mla_common.cuh), one block per (batch row, tile of 16 of the H·C
//     query rows), 32 latent rows a tile in dynamic shared memory; q_rope
//     must be float32 there.
//
// ptxas -v (sm_90a, -O3; build.FLAGS passes it): see PERF.md's kernel
// table, row 6.
#include "mla_common.cuh"
#include "mla_mma.cuh"

// dtype: pool and latent_new 0 = float32, 1 = bfloat16; qrdtype: q_rope
// 0 = float32, 1 = bfloat16 (a float32 pool takes float32 only).  q_abs is
// float32 [B, H, C, r], q_rope [B, H, C, rd], both 16-byte aligned; ctx
// float32 [B, H, C, r], latent_new [B, C, dp].  part: float32 scratch of
// B·max(2·ceil(C·H / 16), nsplit)·16·(r + 2) when a bf16 call's nsplit > 1
// (else null); a row splits its keys into at most nsplit runs of at least
// min_len keys (paged_mla_chunk_quant.py · split_plan; float32 calls pass
// 1).  Returns cudaGetLastError() after the launches (0 on success),
// cudaErrorInvalidValue for an unsupported dtype or r > 512.
extern "C" int paged_mla_chunk(int dtype, int qrdtype, const float* q_abs,
                               const void* q_rope, float* ctx,
                               void* latent_pages, const void* latent_new,
                               const int* block_tables, const int* start,
                               const int* span, float* part, int b, int h,
                               int c, int r, int rd, int dp, int ps, int maxp,
                               int nsplit, int min_len, float scale,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (qrdtype != 0) return static_cast<int>(cudaErrorInvalidValue);
    return mla::run_float<float>(q_abs, static_cast<const float*>(q_rope),
                                 ctx, latent_pages, latent_new, block_tables,
                                 start, span, b, h, c, r, rd, dp, ps, maxp,
                                 scale, s);
  }
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  return mla_mma::run<mla_mma::Bf16Pool, __nv_bfloat16>(
      q_abs, q_rope, qrdtype, ctx, latent_pages, nullptr, latent_new,
      block_tables, start, span, part, b, h, c, r, rd, dp, ps, maxp, nsplit,
      min_len, scale, s);
}
