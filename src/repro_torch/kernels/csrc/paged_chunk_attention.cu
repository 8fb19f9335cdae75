// Chunked mixed-step attention over a paged KV cache, span write fused in
// the same call.  Replaces the TPU kernel
// src/repro/kernels/paged_chunk_attention.py · paged_chunk_attention
// (pl.pallas_call at :196): write the span's K/V into page slots
// start..start+span-1 through the block table, then causal (optionally
// windowed) GQA attention of each span query j over start+j+1 keys.
//
// Bound on the H100: bytes.  Each (row, KV head) reads its live K and V
// pages once (2·kv_len·D·2 bytes in bf16) and the scores are D FMAs per
// key per query row; at OLMo-1B's decode-heavy mixed steps the arithmetic
// intensity stays far below the card's ~295 FLOP/byte ridge.
//
// Design: two launches on the caller's stream.  write_tokens scatters the
// span first, so every key a query may read is resident before any block
// reads it — the TPU kernel's write-then-walk order, kept across blocks
// (a -1 table entry reads page 0, which another row may have just
// written).  The attend launch runs one block per (row, KV head, tile of
// 16 query rows); keys are gathered token by token through the block
// table, so the tile does not depend on page_size.  Blocks whose rows all
// lie past the row's span write zeros and read no keys.
#include "attention_common.cuh"

namespace {

template <typename T, int D>
__global__ void __launch_bounds__(rt::NT)
    chunk_attend(const T* __restrict__ q, T* __restrict__ out,
                 const T* __restrict__ kp, const T* __restrict__ vp,
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
  rt::attend<T, D>(q, out, kp, vp, keys, rows, nrows, maxp * ps, scale,
                   window);
}

template <typename T>
int launch(const void* q, void* out, void* kp, void* vp, const void* kn,
           const void* vn, const int* bt, const int* start, const int* span,
           int b, int hq, int hkv, int c, int d, int ps, int maxp,
           float scale, int window, cudaStream_t stream) {
  if (b == 0 || c == 0) return 0;
  rt::write_tokens<T><<<dim3(b, hkv), rt::NT, 0, stream>>>(
      static_cast<T*>(kp), static_cast<T*>(vp), static_cast<const T*>(kn),
      static_cast<const T*>(vn), bt, start, span, c, d, hkv, ps, maxp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(b, hkv, (hq / hkv * c + rt::QR - 1) / rt::QR);
  RT_DISPATCH_D(d, chunk_attend<T, HD><<<grid, rt::NT, 0, stream>>>(
                       static_cast<const T*>(q), static_cast<T*>(out),
                       static_cast<const T*>(kp), static_cast<const T*>(vp),
                       bt, start, span, hq, hkv, c, ps, maxp, scale, window));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launches (0 on success), cudaErrorInvalidValue for an unsupported
// dtype or head_dim.
extern "C" int paged_chunk_attention(int dtype, const void* q, void* out,
                                     void* k_pages, void* v_pages,
                                     const void* k_new, const void* v_new,
                                     const int* block_tables,
                                     const int* start, const int* span,
                                     int b, int hq, int hkv, int c, int d,
                                     int ps, int maxp, float scale,
                                     int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, out, k_pages, v_pages, k_new, v_new,
                         block_tables, start, span, b, hq, hkv, c, d, ps,
                         maxp, scale, window, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, out, k_pages, v_pages, k_new, v_new,
                                 block_tables, start, span, b, hq, hkv, c, d,
                                 ps, maxp, scale, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
