// Single-query attention over a dense KV cache with a per-row valid length.
// Replaces the TPU kernel src/repro/kernels/decode_attention.py ·
// decode_attention (pl.pallas_call at :95): GQA, no window, keys
// [0, kv_len) of k/v [B, Hkv, S, D].
//
// Bound on the H100: bytes.  Each (row, KV head) streams kv_len·D·2
// elements of K and V once for 2·D FLOPs per key and query head.
//
// Design: one block per (row, KV head) carrying the GQA group as its query
// rows (each key tile is loaded once for the whole group), walking the
// valid prefix in tiles of 32 keys with an online softmax in float32.  The
// TPU kernel's split-K over a padded S is not needed: the walk stops at
// kv_len and the cache is never padded.  head_dim 16-128 keep the tiles in
// static shared memory; head_dim 256 (RecurrentGemma's local attention,
// 10 query heads on 1 KV head) takes them in 82 KB of dynamic shared
// memory, opted into before the launch.  At that shape the grid is
// (B, 1, 1): 8 blocks on 132 SMs, right but latency-bound (split-KV is
// the later change).
#include "attention_common.cuh"

namespace {

template <typename T, int D>
__global__ void __launch_bounds__(rt::NT)
    dense_attend(const T* __restrict__ q, T* __restrict__ out,
                 const T* __restrict__ k, const T* __restrict__ v,
                 const int* __restrict__ kv_len, int hq, int hkv, int s,
                 float scale) {
  const int b = blockIdx.x, h = blockIdx.y;
  const int group = hq / hkv;
  const int g0 = blockIdx.z * rt::QR;
  const int nrows = min(rt::QR, group - g0);
  __shared__ rt::RowSet rows;
  if (threadIdx.x < nrows) {
    rows.off[threadIdx.x] =
        (static_cast<long long>(b) * hq + h * group + g0 + threadIdx.x) * D;
    rows.pos[threadIdx.x] = kv_len[b] - 1;
    rows.on[threadIdx.x] = 1;
  }
  __syncthreads();
  const rt::DenseKeys keys{(static_cast<size_t>(b) * hkv + h) * s * D, D};
  rt::attend<T, D>(q, out, k, v, keys, rows, nrows, s, scale, 0);
}

template <typename T, int D>
int launch_d(const dim3 grid, const void* q, void* out, const void* k,
             const void* v, const int* kv_len, int hq, int hkv, int s,
             float scale, cudaStream_t stream) {
  constexpr size_t smem = rt::dynamic_smem<D>();
  if (smem) {
    const cudaError_t err = cudaFuncSetAttribute(
        dense_attend<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dense_attend<T, D><<<grid, rt::NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<T*>(out),
      static_cast<const T*>(k), static_cast<const T*>(v), kv_len, hq, hkv, s,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, void* out, const void* k, const void* v,
           const int* kv_len, int b, int hq, int hkv, int s, int d,
           float scale, cudaStream_t stream) {
  if (b == 0) return 0;
  const dim3 grid(b, hkv, (hq / hkv + rt::QR - 1) / rt::QR);
  if (d == 256)
    return launch_d<T, 256>(grid, q, out, k, v, kv_len, hq, hkv, s, scale,
                            stream);
  RT_DISPATCH_D(d, return launch_d<T, HD>(grid, q, out, k, v, kv_len, hq,
                                          hkv, s, scale, stream));
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 on success), cudaErrorInvalidValue for an unsupported dtype or
// head_dim.
extern "C" int decode_attention(int dtype, const void* q, void* out,
                                const void* k, const void* v,
                                const int* kv_len, int b, int hq, int hkv,
                                int s, int d, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, out, k, v, kv_len, b, hq, hkv, s, d, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, out, k, v, kv_len, b, hq, hkv, s, d,
                                 scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
