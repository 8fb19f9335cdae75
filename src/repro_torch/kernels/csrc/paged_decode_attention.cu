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
// Design: a decode call is paged_chunk_attention's with span 1 at pos.
// write_tokens (one token a row) runs first, its own launch, so every key
// a query may read is resident before any block reads it (a -1 entry in
// the live range reads page 0, as the plain version does).  Then:
//   - bf16 pools: the tensor-core walk attend_mma::chunk_mma with the
//     Bf16Pool policy in its decode form (span == nullptr, start = pos):
//     a block's rows are the GQA group of its KV head, P·V takes P in two
//     bf16 terms, and the row's keys split over nsplit blocks in ranges of
//     split_len keys (paged_chunk_attention_quant.py · decode_split_plan,
//     from shapes alone), merged by chunk_combine.  The FMA walk this
//     replaces ran one block a (row, KV head) over all its keys: 0.136 ms
//     at the kernel phase against a byte bound of 0.0089 ms (PERF.md).
//   - float32 pools (the CPU-shaped tests' route): decode_attend, the FMA
//     walk of rt::attend, one block a (row, KV head, 16 group heads),
//     float32 throughout.
//   - head_dim 256 (PaliGemma's one KV head of 256, a group of 8): the
//     walk's Bf16Pool256 policy (2 stages of 32 keys, 101,376 B of shared
//     memory, 2 blocks an SM; attend_mma.cuh) on bf16 pools, the float32
//     walk's tiles in dynamic shared memory on float32 pools.
//
// ptxas -v (sm_90a, -O3; build.FLAGS passes it): see PERF.md's kernel
// table, row 2.
#include "attend_mma.cuh"

namespace {

template <int D>
__global__ void __launch_bounds__(rt::NT)
    decode_attend(const float* __restrict__ q, float* __restrict__ out,
                  const float* __restrict__ kp, const float* __restrict__ vp,
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
  rt::attend<float, D>(q, out, kp, vp, keys, rows, nrows, maxp * ps, scale,
                       window);
}

template <typename T>
int write(void* kp, void* vp, const void* kn, const void* vn, const int* bt,
          const int* pos, int b, int hkv, int d, int ps, int maxp,
          cudaStream_t stream) {
  rt::write_tokens<T><<<dim3(b, hkv), rt::NT, 0, stream>>>(
      static_cast<T*>(kp), static_cast<T*>(vp), static_cast<const T*>(kn),
      static_cast<const T*>(vn), bt, pos, nullptr, 1, d, hkv, ps, maxp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: q, pools and k/v_new 0 = float32, 1 = bfloat16.  part: float32
// scratch of B·Hkv·nsplit·(Hq/Hkv)·(D + 2) when a bf16 call's nsplit > 1
// (else null); the key split (nsplit ranges of split_len keys) is
// paged_chunk_attention_quant.py · decode_split_plan's (float32 calls pass
// 1).  Returns cudaGetLastError() after the launches (0 on success),
// cudaErrorInvalidValue for an unsupported dtype or head_dim.
extern "C" int paged_decode_attention(int dtype, const void* q, void* out,
                                      void* k_pages, void* v_pages,
                                      const void* k_new, const void* v_new,
                                      const int* block_tables, const int* pos,
                                      float* part, int b, int hq, int hkv,
                                      int d, int ps, int maxp, float scale,
                                      int window, int nsplit, int split_len,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0) return 0;
  if (dtype == 1) {
    const int err = write<__nv_bfloat16>(k_pages, v_pages, k_new, v_new,
                                         block_tables, pos, b, hkv, d, ps,
                                         maxp, s);
    if (err) return err;
    return attend_mma::attend<__nv_bfloat16, attend_mma::Bf16Pool>(
        q, out, k_pages, v_pages, nullptr, nullptr, block_tables, pos,
        nullptr, part, b, hq, hkv, 1, d, ps, maxp, scale, window, nsplit,
        split_len, s);
  }
  const int err = write<float>(k_pages, v_pages, k_new, v_new, block_tables,
                               pos, b, hkv, d, ps, maxp, s);
  if (err) return err;
  const dim3 grid(b, hkv, (hq / hkv + rt::QR - 1) / rt::QR);
  RT_DISPATCH_D(d, const cudaError_t e = rt::opt_in<HD>(decode_attend<HD>);
                if (e != cudaSuccess) return static_cast<int>(e);
                decode_attend<HD><<<grid, rt::NT, rt::dynamic_smem<HD>(), s>>>(
                       static_cast<const float*>(q), static_cast<float*>(out),
                       static_cast<const float*>(k_pages),
                       static_cast<const float*>(v_pages), block_tables, pos,
                       hq, hkv, ps, maxp, scale, window));
  return static_cast<int>(cudaGetLastError());
}
