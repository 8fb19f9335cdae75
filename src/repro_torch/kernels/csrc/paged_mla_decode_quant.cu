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
// Design: a decode call is paged_mla_chunk_quant's with span 1 at pos
// (span == nullptr on the card).  write_latent_quant (one warp a row,
// bitwise the plain version's quantize_rows; quant_common.cuh) runs first
// as its own launch, then the tensor-core walk mla_mma::walk with the
// CodePool policy (mla_mma.cuh): a row's 16 heads are one m16 tile, raw
// int8 / e4m3 rows by cp.async, the scale after the dot, q read in place
// as three bf16 terms and p·s as three, the row's pos+1 keys split over up
// to nsplit blocks in runs of 32 keys (paged_mla_chunk_quant.py ·
// decode_split_plan, from shapes), merged by mla_mma::combine.  The FMA
// walk this replaces ran one block per row: 0.840 ms against a byte bound
// of 0.00080 ms (PERF.md).
//
// ptxas -v (sm_90a, -O3; build.FLAGS passes it): see PERF.md's kernel
// table, row 9.
#include "mla_common.cuh"
#include "mla_mma.cuh"

// kvdtype: latent_new 0 = float32, 1 = bfloat16; qdtype: pool 0 = int8,
// 1 = fp8-e4m3; qrdtype: q_rope 0 = float32, 1 = bfloat16.  q_abs float32
// [B, H, r], q_rope [B, H, rd], both 16-byte aligned; ctx float32 [B, H,
// r], latent_new [B, dp], scales float32 [P, ps], pos i32[B] (< maxp*ps);
// part: float32 scratch of B·max(2·ceil(H / 16), nsplit)·16·(r + 2) (null
// when nsplit is 1); the row's keys split into at most nsplit runs of at
// least min_len keys.  Returns cudaGetLastError() after the launches (0 on
// success), cudaErrorInvalidValue for an unsupported dtype or r > 512.
extern "C" int paged_mla_decode_quant(int kvdtype, int qdtype, int qrdtype,
                                      const float* q_abs, const void* q_rope,
                                      float* ctx, void* latent_pages,
                                      float* latent_scales,
                                      const void* latent_new,
                                      const int* block_tables,
                                      const int* pos, float* part, int b,
                                      int h, int r, int rd, int dp, int ps,
                                      int maxp, int nsplit, int min_len,
                                      float scale, void* stream) {
#define MLA_RUN(IT, C)                                                     \
  mla_mma::run<mla_mma::CodePool<C>, IT>(                                  \
      q_abs, q_rope, qrdtype, ctx, latent_pages, latent_scales, latent_new, \
      block_tables, pos, nullptr, part, b, h, 1, r, rd, dp, ps, maxp,       \
      nsplit, min_len, scale, static_cast<cudaStream_t>(stream))
  RT_DISPATCH_QUANT(kvdtype, qdtype, MLA_RUN);
#undef MLA_RUN
}
