// Chunked mixed-step attention over a quantized paged KV cache (int8 or
// fp8-e4m3 pools with one f32 scale per pool row), the span's quantizing
// write fused in the same call.  Replaces the TPU kernel
// src/repro/kernels/paged_chunk_attention.py · paged_chunk_attention_quant
// (pl.pallas_call at :389, kernel body _mha_kernel_quant at :210): quantize
// the span's K/V rows into slots start..start+span-1 through the block
// table, then causal (optionally windowed) GQA attention of each span query
// j over start+j+1 dequantized keys.
//
// Bound on the H100: bytes.  The walk reads each live K and V row once at
// one byte per value plus 4 bytes of scale; the scores are D FMAs per key
// per query row, far below the card's ridge at the mixed steps' spans.
//
// Design: write_tokens_quant scatters and quantizes the span first (its own
// launch, so every key a query may read is resident before any block reads
// it, and a -1 entry reads page 0 as the plain version does).  Then the
// walk of paged_chunk_attention — one block per (row, KV head, tile of 16
// query rows), keys gathered token by token through the block table — with
// the dequantizing loader of quant_common.cuh.  Blocks whose rows all lie
// past the row's span write zeros and read no keys.  No atomics.
#include "quant_common.cuh"

namespace {

template <typename T, class Codec, int D>
__global__ void __launch_bounds__(rt::NT)
    chunk_attend_quant(const T* __restrict__ q, T* __restrict__ out,
                       const typename Codec::S* __restrict__ kp,
                       const typename Codec::S* __restrict__ vp,
                       const float* __restrict__ ks,
                       const float* __restrict__ vs,
                       const int* __restrict__ bt,
                       const int* __restrict__ start,
                       const int* __restrict__ span, int hq, int hkv, int c,
                       int ps, int maxp, float scale, int window) {
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
  const rt::QuantKV<Codec> kv{kp, vp, ks, vs, keys};
  rt::attend_kv<T, D>(q, out, kv, rows, nrows, maxp * ps, scale, window);
}

template <typename T, class Codec>
int launch(const void* q, void* out, const void* kp, const void* vp,
           const float* ks, const float* vs, const int* bt, const int* start,
           const int* span, int b, int hq, int hkv, int c, int d, int ps,
           int maxp, float scale, int window, cudaStream_t stream) {
  using S = typename Codec::S;
  const dim3 grid(b, hkv, (hq / hkv * c + rt::QR - 1) / rt::QR);
  RT_DISPATCH_D(d, chunk_attend_quant<T, Codec, HD><<<grid, rt::NT, 0,
                                                      stream>>>(
                       static_cast<const T*>(q), static_cast<T*>(out),
                       static_cast<const S*>(kp), static_cast<const S*>(vp),
                       ks, vs, bt, start, span, hq, hkv, c, ps, maxp, scale,
                       window));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: q/out, kvdtype: k/v_new, each 0 = float32, 1 = bfloat16; qdtype:
// pools 0 = int8, 1 = fp8-e4m3.  k/v_new are [B, Hkv, C, D]; scales
// float32 [P, Hkv, ps].  Returns cudaGetLastError() after the launches (0
// on success), cudaErrorInvalidValue for an unsupported dtype or head_dim.
extern "C" int paged_chunk_attention_quant(
    int dtype, int kvdtype, int qdtype, const void* q, void* out,
    void* k_pages, void* v_pages, float* k_scales, float* v_scales,
    const void* k_new, const void* v_new, const int* block_tables,
    const int* start, const int* span, int b, int hq, int hkv, int c, int d,
    int ps, int maxp, float scale, int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b == 0 || c == 0) return 0;
  const int err = rt::write_quant(kvdtype, qdtype, k_pages, v_pages,
                                  k_scales, v_scales, k_new, v_new,
                                  block_tables, start, span, b, c, d, hkv, ps,
                                  maxp, s);
  if (err) return err;
#define RT_CALL(T, C)                                                     \
  launch<T, C>(q, out, k_pages, v_pages, k_scales, v_scales, block_tables, \
               start, span, b, hq, hkv, c, d, ps, maxp, scale, window, s)
  RT_DISPATCH_QUANT(dtype, qdtype, RT_CALL);
#undef RT_CALL
}
