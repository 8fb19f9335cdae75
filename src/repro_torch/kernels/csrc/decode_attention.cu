// Single-query attention over a dense KV cache with a per-row valid length.
// Replaces the TPU kernel src/repro/kernels/decode_attention.py ·
// decode_attention (pl.pallas_call at :95): GQA, no window, keys
// [0, kv_len) of k/v [B, Hkv, S, D].
//
// Bound on the H100: bytes.  Each (row, KV head) streams kv_len·D·2
// elements of K and V once for 2·D FLOPs per key and query head.
//
// Design: split-KV, two launches, both named dense_attend_* so one profiler
// match sums them.
//
// dense_attend_split, grid (B·Hq, nsplit): a block takes one query row
// (b, h) over one range of keys [i·L, min((i+1)·L, kv_len[b])) of its KV
// head h / (Hq / Hkv).  The plan (nsplit, L) comes from the wrapper,
// computed from shapes alone (kernels/decode_attention.py · split_plan):
// kv_len stays on the card.  A block whose range starts at or past
// kv_len[b] writes the empty partial (M = -inf, L = 0) and exits.
//   - Lanes split D, warps take keys: LPK = min(32, D / (16 B)) lanes read
//     one key's K and V rows with one 16-byte load each (a D-256 bf16 row
//     is one uint4 a lane; at D 128 a half-warp takes a key, at D 64 a
//     quarter), 32 / LPK keys a warp step, 4 steps' loads in flight.
//   - A dot product is D / LPK products a lane against the scaled query
//     (q · scale · log2 e, kept in shared memory as float), then a shuffle
//     reduction over the LPK lanes: no serial D-long loop.
//   - Online softmax in float32 per warp with exp2f, one rescale for the 4
//     steps' keys (their scores are independent chains); m is shared by
//     the warp's key groups, each lane keeps l and the P·V accumulators of
//     its D slice (D / LPK floats).  exp2 of (-inf) - (-inf) is guarded by
//     taking 0 as the max.
//   - Block end: the warp's key groups add up by shuffles, the 4 warps
//     rescale to the block's max M and add up in shared memory in warp
//     order (deterministic).  The partial of a range is
//         M = max_t s_t,  L = sum_t 2^(s_t - M),  acc = sum_t 2^(s_t - M)·v_t
//     over its keys, s_t = (q · k_t) · scale · log2 e, written as float32
//     part_acc [B, Hq, nsplit, D] and part_ml [B, Hq, nsplit, 2] = (M, L).
//     With one split the block writes out = acc / L itself (0 where the
//     range is empty) and there is no second launch.
//   - The query heads of a GQA group read the same K/V rows: their blocks
//     are neighbours in the grid, so the group's second and later reads
//     come from L2.  Blocks that each kept a whole group's accumulators
//     (16 × 8 floats a lane at D 256) held the card to 2 blocks an SM, and
//     a group walk that staged scores in shared memory ran its rows'
//     shuffle chains one after another: both measured slower on the H100
//     at RecurrentGemma's group of 10 (PERF.md, kernel table notes).
//
// dense_attend_combine, grid (B·Hq, D/32), 8 warps: out = sum_i
// 2^(M_i - M)·acc_i / sum_i 2^(M_i - M)·L_i with M = max_i M_i, skipping
// empty partials (their acc is never written).  A lane takes a column,
// a warp every 8th split (independent loads in flight), and the 8 warps
// add up in shared memory.  A row whose M is -inf (kv_len 0) gives 0, never
// NaN, as the walk before split-KV did.
//
// Tensor cores are not needed: the work is bytes.  float32 stays float32.
// ptxas -v (sm_90a, -O3; build.FLAGS passes it): dense_attend_split 64
// registers (bf16) and 56 (float32) at every head_dim, the combine 31, no
// spill.
#include "attention_common.cuh"

namespace {

constexpr int NT = 128;            // threads per block
constexpr int NW = NT / 32;        // warps per block
constexpr int MAX_SPLITS = 256;    // the combine's weights in shared memory
constexpr int CT = 256;            // combine threads: 8 warps of splits
constexpr float LOG2E = 1.4426950408889634f;

template <typename T, int N>
__device__ __forceinline__ void widen(const uint4 (&raw)[N], float* f) {
  const T* e = reinterpret_cast<const T*>(raw);
#pragma unroll
  for (int i = 0; i < N * 16 / static_cast<int>(sizeof(T)); ++i)
    f[i] = rt::to_f(e[i]);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    dense_attend_split(const T* __restrict__ q, T* __restrict__ out,
                       const T* __restrict__ k, const T* __restrict__ v,
                       const int* __restrict__ kv_len,
                       float* __restrict__ part_acc,
                       float* __restrict__ part_ml, int hq, int hkv, int s,
                       int split_len, int nsplit, float scale_log2) {
  constexpr int VEC = 16 / sizeof(T);                // elements a load
  constexpr int LPK = D / VEC < 32 ? D / VEC : 32;   // lanes a key
  constexpr int EPL = D / LPK;                       // elements a lane
  constexpr int LDS = EPL / VEC;                     // loads a lane a row
  constexpr int KPW = 32 / LPK;                      // keys a warp step
  constexpr int KPB = NW * KPW;                      // keys a block step
  constexpr int U = 4 / LDS;                         // steps in flight
  static_assert(EPL % VEC == 0 && EPL % 4 == 0, "head_dim");
  __shared__ __align__(16) float q_s[D];
  __shared__ __align__(16) float acc_s[D];
  __shared__ float m_s[NW], l_s[NW], bm_s, bl_s;

  const size_t row = blockIdx.x;           // b * hq + h
  const int b = blockIdx.x / hq, h = blockIdx.x % hq, split = blockIdx.y;
  const int len = min(max(kv_len[b], 0), s);
  const int t_lo = split * split_len;
  const int t_hi = min(len, t_lo + split_len);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (t_lo >= t_hi) {                // an empty range
    if (nsplit == 1) {
      for (int i = tid; i < D; i += NT) out[row * D + i] = rt::from_f<T>(0.f);
    } else if (tid == 0) {
      part_ml[(row * nsplit + split) * 2] = -INFINITY;
      part_ml[(row * nsplit + split) * 2 + 1] = 0.f;
    }
    return;
  }
  for (int i = tid; i < D; i += NT)
    q_s[i] = rt::to_f(q[row * D + i]) * scale_log2;
  __syncthreads();

  const int kg = lane / LPK;               // this lane's key in a step
  const int d0 = (lane % LPK) * EPL;       // and its D slice
  const size_t kvbase =
      (static_cast<size_t>(b) * hkv + h / (hq / hkv)) * s * D + d0;
  float m = -INFINITY, l = 0.f, acc[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) acc[e] = 0.f;

  for (int t0 = t_lo + warp * KPW; t0 < t_hi; t0 += U * KPB) {
    uint4 kr[U][LDS], vr[U][LDS];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u * KPB + kg;
#pragma unroll
      for (int i = 0; i < LDS; ++i) {
        if (t < t_hi) {
          const size_t o = kvbase + static_cast<size_t>(t) * D + i * VEC;
          kr[u][i] = *reinterpret_cast<const uint4*>(k + o);
          vr[u][i] = *reinterpret_cast<const uint4*>(v + o);
        } else {
          kr[u][i] = vr[u][i] = make_uint4(0, 0, 0, 0);
        }
      }
    }
    // The U keys' scores are independent chains; one rescale for all.
    float sc[U];
    float mx = -INFINITY;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[EPL];
      widen<T>(kr[u], kf);
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; e += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(&q_s[d0 + e]);
        dot = fmaf(qv.x, kf[e], dot);
        dot = fmaf(qv.y, kf[e + 1], dot);
        dot = fmaf(qv.z, kf[e + 2], dot);
        dot = fmaf(qv.w, kf[e + 3], dot);
      }
#pragma unroll
      for (int o = 1; o < LPK; o <<= 1)      // the whole warp shuffles
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      sc[u] = t0 + u * KPB + kg < t_hi ? dot : -INFINITY;
      mx = fmaxf(mx, sc[u]);
    }
#pragma unroll
    for (int o = LPK; o < 32; o <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float mn = fmaxf(m, mx);
    const float mu = mn == -INFINITY ? 0.f : mn;
    const float alpha = exp2f(m - mu);
    l *= alpha;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[e] *= alpha;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float p = exp2f(sc[u] - mu);
      float vf[EPL];
      widen<T>(vr[u], vf);
      l += p;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[e] = fmaf(p, vf[e], acc[e]);
    }
    m = mn;
  }

  // The warp's key groups share m: add their l and accumulators.
#pragma unroll
  for (int o = LPK; o < 32; o <<= 1) {
    l += __shfl_xor_sync(0xffffffffu, l, o);
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
  }
  if (lane == 0) {
    m_s[warp] = m;
    l_s[warp] = l;
  }
  __syncthreads();
  if (tid == 0) {                    // the block's M and L
    float bm = -INFINITY, bl = 0.f;
    for (int w = 0; w < NW; ++w) bm = fmaxf(bm, m_s[w]);
    for (int w = 0; w < NW; ++w)
      if (m_s[w] != -INFINITY) bl += l_s[w] * exp2f(m_s[w] - bm);
    bm_s = bm;
    bl_s = bl;
  }
  __syncthreads();
  // Warps add their rescaled accumulators in order 0..3.
  const float f = m == -INFINITY ? 0.f : exp2f(m - bm_s);
  for (int w = 0; w < NW; ++w) {
    if (warp == w && lane < LPK) {
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        acc_s[d0 + e] = (w == 0 ? 0.f : acc_s[d0 + e]) + acc[e] * f;
    }
    __syncthreads();
  }
  for (int d = tid; d < D; d += NT) {
    if (nsplit == 1) {
      out[row * D + d] =
          rt::from_f<T>(bl_s > 0.f ? acc_s[d] / bl_s : 0.f);
    } else {
      part_acc[(row * nsplit + split) * D + d] = acc_s[d];
    }
  }
  if (nsplit > 1 && tid == 0) {
    part_ml[(row * nsplit + split) * 2] = bm_s;
    part_ml[(row * nsplit + split) * 2 + 1] = bl_s;
  }
}

template <typename T>
__global__ void __launch_bounds__(CT)
    dense_attend_combine(const float* __restrict__ part_acc,
                         const float* __restrict__ part_ml,
                         T* __restrict__ out, int nsplit, int d) {
  __shared__ float w_s[MAX_SPLITS];
  __shared__ float x_s[CT / 32][32];
  __shared__ float inv_s;
  const size_t row = blockIdx.x;             // b * hq + query head
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.y * 32 + lane;      // this lane's column
  const float* ml = part_ml + row * nsplit * 2;
  if (warp == 0) {
    float mx = -INFINITY;
    for (int i = lane; i < nsplit; i += 32) mx = fmaxf(mx, ml[2 * i]);
    mx = rt::warp_max(mx);
    float sum = 0.f;
    for (int i = lane; i < nsplit; i += 32) {
      const float mi = ml[2 * i];
      const float wi = mi == -INFINITY ? 0.f : exp2f(mi - mx);
      w_s[i] = wi;
      sum += wi * ml[2 * i + 1];
    }
    sum = rt::warp_sum(sum);
    if (lane == 0) inv_s = sum > 0.f ? 1.f / sum : 0.f;
  }
  __syncthreads();
  // Warp w sums splits w, w + 8, ...: the loads are independent of each
  // other; an empty split's acc (never written) is read but not used.
  float x = 0.f;
  if (c < d) {
    const float* acc = part_acc + row * nsplit * d + c;
#pragma unroll 4
    for (int i = warp; i < nsplit; i += CT / 32) {
      const float a = acc[static_cast<size_t>(i) * d];
      const float wi = w_s[i];
      x += wi > 0.f ? wi * a : 0.f;
    }
  }
  x_s[warp][lane] = x;
  __syncthreads();
  if (warp == 0 && c < d) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < CT / 32; ++w) sum += x_s[w][lane];
    out[row * d + c] = rt::from_f<T>(sum * inv_s);
  }
}

template <typename T, int D>
int launch_d(const void* q, void* out, const void* k, const void* v,
             const int* kv_len, float* part_acc, float* part_ml, int b,
             int hq, int hkv, int s, int split_len, int nsplit, float scale,
             cudaStream_t stream) {
  dense_attend_split<T, D><<<dim3(b * hq, nsplit), NT, 0, stream>>>(
      static_cast<const T*>(q), static_cast<T*>(out),
      static_cast<const T*>(k), static_cast<const T*>(v), kv_len, part_acc,
      part_ml, hq, hkv, s, split_len, nsplit, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, void* out, const void* k, const void* v,
           const int* kv_len, float* part_acc, float* part_ml, int b, int hq,
           int hkv, int s, int d, int nsplit, int split_len, float scale,
           cudaStream_t stream) {
  if (b == 0) return 0;
  if (nsplit < 1 || nsplit > MAX_SPLITS ||
      static_cast<long long>(nsplit) * split_len < s ||
      (nsplit > 1 && (part_acc == nullptr || part_ml == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  int err;
  switch (d) {
#define DA_D(HD)                                                           \
  case HD:                                                                 \
    err = launch_d<T, HD>(q, out, k, v, kv_len, part_acc, part_ml, b, hq,  \
                          hkv, s, split_len, nsplit, scale, stream);       \
    break;
    DA_D(16) DA_D(32) DA_D(64) DA_D(128) DA_D(256)
#undef DA_D
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err || nsplit == 1) return err;
  dense_attend_combine<T><<<dim3(b * hq, (d + 31) / 32), CT, 0, stream>>>(
      part_acc, part_ml, static_cast<T*>(out), nsplit, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; nsplit (<= 256) and split_len (nsplit ·
// split_len >= s) from the wrapper's split plan; part_acc / part_ml float32
// scratch [B, Hq, nsplit, D] and [B, Hq, nsplit, 2], unused (may be null)
// when nsplit is 1.  Returns cudaGetLastError() after the launches (0 on
// success), cudaErrorInvalidValue for an unsupported dtype, head_dim or
// plan.
extern "C" int decode_attention(int dtype, const void* q, void* out,
                                const void* k, const void* v,
                                const int* kv_len, void* part_acc,
                                void* part_ml, int b, int hq, int hkv, int s,
                                int d, int nsplit, int split_len, float scale,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  if (dtype == 0)
    return launch<float>(q, out, k, v, kv_len, pa, pm, b, hq, hkv, s, d,
                         nsplit, split_len, scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, out, k, v, kv_len, pa, pm, b, hq, hkv, s,
                                 d, nsplit, split_len, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
