// Chunked mixed-step attention over a paged KV cache, span write fused in
// the same call.  Replaces the TPU kernel
// src/repro/kernels/paged_chunk_attention.py · paged_chunk_attention
// (pl.pallas_call at :196): write the span's K/V into page slots
// start..start+span-1 through the block table, then causal (optionally
// windowed) GQA attention of each span query j over start+j+1 keys.
//
// Bound on the H100: bytes.  Each (row, KV head) reads its live K and V
// pages once (2·kv_len·D·2 bytes in bf16) and the scores are D MACs per
// key per query row; at OLMo-1B's decode-heavy mixed steps the arithmetic
// intensity stays far below the card's ~295 FLOP/byte ridge.
//
// Design: two launches on the caller's stream (three when the keys are
// split).  write_tokens scatters the span first (a warp a token row, over
// (B, Hkv, ceil(C / 4)) blocks), so every key a query may read is
// resident before any block reads it — the TPU kernel's
// write-then-walk order, kept across blocks (a -1 table entry reads page 0,
// which another row may have just written).  Then the walk:
//   - bf16 pools: the tensor-core walk attend_mma::chunk_mma with the
//     Bf16Pool policy (attend_mma.cuh: one block a (row, KV head) walking
//     its live query rows 64 at a time, bf16 K/V rows by cp.async straight
//     into the ring the warps ldmatrix from, mma.sync with P rounded to
//     bf16 once, keys split over blocks by split_plan, a combine launch) —
//     the walk of paged_chunk_attention_quant, with unit scales left out.
//   - float32 pools (the CPU-shaped tests' route): chunk_attend, the FMA
//     walk of rt::attend, one block per (row, KV head, tile of 16 query
//     rows), float32 throughout.
//   - head_dim 256: the walk's Bf16Pool256 policy on bf16 pools (2 blocks
//     an SM; split_plan aims at them), the float32 walk's tiles in dynamic
//     shared memory.  No path runs it yet: the mixed step refuses a
//     prefix-LM, as JAX's does.
//
// ptxas -v (sm_90a, -O3; build.FLAGS passes it): see PERF.md's kernel
// table, row 1.
#include "attend_mma.cuh"

namespace {

template <int D>
__global__ void __launch_bounds__(rt::NT)
    chunk_attend(const float* __restrict__ q, float* __restrict__ out,
                 const float* __restrict__ kp, const float* __restrict__ vp,
                 const int* __restrict__ bt, const int* __restrict__ start,
                 const int* __restrict__ span, int hq, int hkv, int c, int ps,
                 int maxp, float scale, int window) {
  const int b = blockIdx.x, h = blockIdx.y;
  const int group = hq / hkv;
  const int r0 = blockIdx.z * rt::QR;
  const int nrows = min(rt::QR, group * c - r0);
  __shared__ rt::RowSet rows;
  if (threadIdx.x < nrows) {
    const int rr = r0 + threadIdx.x;
    const int g = rr / c, j = rr % c;
    rows.off[threadIdx.x] =
        ((static_cast<long long>(b) * hq + h * group + g) * c + j) * D;
    rows.pos[threadIdx.x] = start[b] + j;
    rows.on[threadIdx.x] = j < span[b];
  }
  __syncthreads();
  const rt::PagedKeys keys{bt + static_cast<size_t>(b) * maxp, hkv, h, ps, D};
  rt::attend<float, D>(q, out, kp, vp, keys, rows, nrows, maxp * ps, scale,
                       window);
}

template <typename T>
int write(void* kp, void* vp, const void* kn, const void* vn, const int* bt,
          const int* start, const int* span, int b, int hkv, int c, int d,
          int ps, int maxp, cudaStream_t stream) {
  rt::write_tokens<T>
      <<<dim3(b, hkv, (c + rt::NT / 32 - 1) / (rt::NT / 32)), rt::NT, 0,
         stream>>>(
      static_cast<T*>(kp), static_cast<T*>(vp), static_cast<const T*>(kn),
      static_cast<const T*>(vn), bt, start, span, c, d, hkv, ps, maxp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: q, pools and k/v_new 0 = float32, 1 = bfloat16.  part: float32
// scratch of B·Hkv·nsplit·C·(Hq/Hkv)·(D + 2) when a bf16 call's nsplit > 1
// (else null); the key split (nsplit ranges of split_len keys) is
// paged_chunk_attention.py · split_plan's (float32 calls pass 1).
// Returns cudaGetLastError() after the launches (0 on success),
// cudaErrorInvalidValue for an unsupported dtype or head_dim.
extern "C" int paged_chunk_attention(int dtype, const void* q, void* out,
                                     void* k_pages, void* v_pages,
                                     const void* k_new, const void* v_new,
                                     const int* block_tables,
                                     const int* start, const int* span,
                                     float* part, int b, int hq, int hkv,
                                     int c, int d, int ps, int maxp,
                                     float scale, int window, int nsplit,
                                     int split_len, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || c == 0) return 0;
  if (dtype == 1) {
    const int err = write<__nv_bfloat16>(k_pages, v_pages, k_new, v_new,
                                         block_tables, start, span, b, hkv,
                                         c, d, ps, maxp, s);
    if (err) return err;
    return attend_mma::attend<__nv_bfloat16, attend_mma::Bf16Pool>(
        q, out, k_pages, v_pages, nullptr, nullptr, block_tables, start,
        span, part, b, hq, hkv, c, d, ps, maxp, scale, window, nsplit,
        split_len, s);
  }
  const int err = write<float>(k_pages, v_pages, k_new, v_new, block_tables,
                               start, span, b, hkv, c, d, ps, maxp, s);
  if (err) return err;
  const dim3 grid(b, hkv, (hq / hkv * c + rt::QR - 1) / rt::QR);
  RT_DISPATCH_D(d, const cudaError_t e = rt::opt_in<HD>(chunk_attend<HD>);
                if (e != cudaSuccess) return static_cast<int>(e);
                chunk_attend<HD><<<grid, rt::NT, rt::dynamic_smem<HD>(), s>>>(
                       static_cast<const float*>(q), static_cast<float*>(out),
                       static_cast<const float*>(k_pages),
                       static_cast<const float*>(v_pages), block_tables,
                       start, span, hq, hkv, c, ps, maxp, scale, window));
  return static_cast<int>(cudaGetLastError());
}
