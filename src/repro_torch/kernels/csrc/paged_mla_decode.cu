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
// Design: a decode call is paged_mla_chunk's with span 1 at pos (span ==
// nullptr on the card: no tensor of ones).  write_latent copies the
// token's Dp-wide row first (its own launch, one warp a row: the walk
// reads a fully written pool, a -1 entry reads page 0 as in the plain
// version; pool bytes bitwise).  Then:
//   - bf16 pool: the tensor-core walk mla_mma::walk with the Bf16Pool
//     policy (mla_mma.cuh): a row's 16 heads are one m16 tile, q is read
//     in place (q_abs float32, q_rope float32 or bf16) as three bf16
//     terms, and the row's pos+1 keys split over up to nsplit blocks in
//     runs of 32 keys (paged_mla_chunk_quant.py · decode_split_plan, from
//     shapes: 17 splits, 136 blocks at 8 rows), merged by
//     mla_mma::combine.  The FMA walk this replaces ran one block per
//     row: 8 blocks on 132 SMs, 0.666 ms against a byte bound of 0.00142
//     ms (PERF.md).
//   - float32 pool (the CPU-shaped tests' route): the FMA walk mla::attend
//     (mla_common.cuh), q_rope float32.
//
// ptxas -v (sm_90a, -O3; build.FLAGS passes it): see PERF.md's kernel
// table, row 8.
#include "mla_common.cuh"
#include "mla_mma.cuh"

// dtype: pool and latent_new 0 = float32, 1 = bfloat16; qrdtype: q_rope
// 0 = float32, 1 = bfloat16 (a float32 pool takes float32 only).  q_abs is
// float32 [B, H, r], q_rope [B, H, rd], both 16-byte aligned; ctx float32
// [B, H, r], latent_new [B, dp], pos i32[B] (< maxp*ps).  part: float32
// scratch of B·max(2·ceil(H / 16), nsplit)·16·(r + 2) when a bf16 call's
// nsplit > 1 (else null); the row's keys split into at most nsplit runs of
// at least min_len keys (float32 calls pass 1).  Returns cudaGetLastError()
// after the launches (0 on success), cudaErrorInvalidValue for an
// unsupported dtype or r > 512.
extern "C" int paged_mla_decode(int dtype, int qrdtype, const float* q_abs,
                                const void* q_rope, float* ctx,
                                void* latent_pages, const void* latent_new,
                                const int* block_tables, const int* pos,
                                float* part, int b, int h, int r, int rd,
                                int dp, int ps, int maxp, int nsplit,
                                int min_len, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (qrdtype != 0) return static_cast<int>(cudaErrorInvalidValue);
    return mla::run_float<float>(q_abs, static_cast<const float*>(q_rope),
                                 ctx, latent_pages, latent_new, block_tables,
                                 pos, nullptr, b, h, 1, r, rd, dp, ps, maxp,
                                 scale, s);
  }
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  return mla_mma::run<mla_mma::Bf16Pool, __nv_bfloat16>(
      q_abs, q_rope, qrdtype, ctx, latent_pages, nullptr, latent_new,
      block_tables, pos, nullptr, part, b, h, 1, r, rd, dp, ps, maxp, nsplit,
      min_len, scale, s);
}
