// Single-token decode over a paged KV cache, token write fused in the same
// call.  Replaces the TPU kernel
// src/repro/kernels/paged_decode_attention.py · paged_decode_attention
// (pl.pallas_call at :179): write the token at pos through the block
// table, then attend over pos+1 keys, sliding window optional.
//
// Bound on the H100: bytes.  Decode reads each row's live K and V pages
// once (2·(pos+1)·D·2 bytes per (row, KV head) in bf16) for 2·D FLOPs per
// key and query head: about one FLOP per byte.
//
// Design: write_tokens (one token per row) first, then one attend block
// per (row, KV head) that carries the whole GQA group as its query rows,
// so each key tile is loaded once for every query head that reads it.
// Keys are gathered token by token through the block table (any
// page_size); -1 entries in the live range read page 0, as the oracle's.
#include "attention_common.cuh"

namespace {

template <typename T, int D>
__global__ void __launch_bounds__(rt::NT)
    decode_attend(const T* __restrict__ q, T* __restrict__ out,
                  const T* __restrict__ kp, const T* __restrict__ vp,
                  const int* __restrict__ bt, const int* __restrict__ pos,
                  int hq, int hkv, int ps, int maxp, float scale,
                  int window) {
  const int b = blockIdx.x, h = blockIdx.y;
  const int group = hq / hkv;
  const int g0 = blockIdx.z * rt::QR;
  const int nrows = min(rt::QR, group - g0);
  __shared__ rt::RowSet rows;
  if (threadIdx.x < nrows) {
    rows.off[threadIdx.x] =
        (static_cast<long long>(b) * hq + h * group + g0 + threadIdx.x) * D;
    rows.pos[threadIdx.x] = pos[b];
    rows.on[threadIdx.x] = 1;
  }
  __syncthreads();
  const rt::PagedKeys keys{bt + static_cast<size_t>(b) * maxp, hkv, h, ps, D};
  rt::attend<T, D>(q, out, kp, vp, keys, rows, nrows, maxp * ps, scale,
                   window);
}

template <typename T>
int launch(const void* q, void* out, void* kp, void* vp, const void* kn,
           const void* vn, const int* bt, const int* pos, int b, int hq,
           int hkv, int d, int ps, int maxp, float scale, int window,
           cudaStream_t stream) {
  if (b == 0) return 0;
  rt::write_tokens<T><<<dim3(b, hkv), rt::NT, 0, stream>>>(
      static_cast<T*>(kp), static_cast<T*>(vp), static_cast<const T*>(kn),
      static_cast<const T*>(vn), bt, pos, nullptr, 1, d, hkv, ps, maxp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(b, hkv, (hq / hkv + rt::QR - 1) / rt::QR);
  RT_DISPATCH_D(d, decode_attend<T, HD><<<grid, rt::NT, 0, stream>>>(
                       static_cast<const T*>(q), static_cast<T*>(out),
                       static_cast<const T*>(kp), static_cast<const T*>(vp),
                       bt, pos, hq, hkv, ps, maxp, scale, window));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launches (0 on success), cudaErrorInvalidValue for an unsupported
// dtype or head_dim.
extern "C" int paged_decode_attention(int dtype, const void* q, void* out,
                                      void* k_pages, void* v_pages,
                                      const void* k_new, const void* v_new,
                                      const int* block_tables, const int* pos,
                                      int b, int hq, int hkv, int d, int ps,
                                      int maxp, float scale, int window,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, out, k_pages, v_pages, k_new, v_new,
                         block_tables, pos, b, hq, hkv, d, ps, maxp, scale,
                         window, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, out, k_pages, v_pages, k_new, v_new,
                                 block_tables, pos, b, hq, hkv, d, ps, maxp,
                                 scale, window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
