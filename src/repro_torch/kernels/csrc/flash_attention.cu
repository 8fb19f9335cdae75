// Blocked attention with an online softmax over whole sequences: q
// [B, Hq, Tq, D], k/v [B, Hkv, Tk, D] (GQA: query head h reads KV head
// h / (Hq / Hkv)), an optional causal mask and sliding window, Tq != Tk with
// the ends aligned (query i sits at key position i + Tk - Tq).
// Replaces the TPU kernel src/repro/kernels/flash_attention.py ·
// flash_attention (pl.pallas_call at :127, kernel _attn_kernel at :30).
//
// Bound on the H100: operations.  At the whisper encoder's shape (Tq = Tk =
// 1500, D 64) each query row reads every key twice (QK^T and PV): 4·D FLOPs
// per (query, key) pair against 2 B a value moved once, about 500 FLOPs a
// byte, past the bf16 ridge (~295).
//
// Design (a first, simple one: float32 FMAs, no tensor cores, no TMA):
// one block of 128 threads per (b·Hq, tile of 32 query rows), walking the
// keys the tile needs in tiles of 64.  Each tile of K and V is staged in
// shared memory as float; every thread owns a 4 × 4 block of scores (4
// query rows 8 apart, 4 keys 16 apart) and the same 4 rows × D/16 columns
// of the output, so the online-softmax row statistics (running max m, sum
// l) live in registers and reduce across the 16 lanes sharing the rows
// with shuffles.  m, l and the accumulator are float32; out = acc /
// max(l, 1e-30), as the TPU kernel's finalize.  Masks use the true Tq and
// Tk: nothing is padded, and tiles entirely outside every row's causal or
// window range are skipped.  A query row with no live key (causal with
// Tq > Tk, or a window that empties it) gives 0 — its l stays 0 and so
// does its accumulator — where the plain version gives NaN.  The tiles
// take 49 KB at D 64 (4 blocks an SM) and 89 KB at D 128, in dynamic shared
// memory.
#include "attention_common.cuh"

namespace {

constexpr int FT = 128;           // threads per block
constexpr int BQ = 32;            // query rows per block
constexpr int BK = 64;            // keys per tile
constexpr int RPT = BQ / 8;       // query rows per thread: 8 row groups
constexpr int KPT = BK / 16;      // keys per thread: 16 key lanes

template <int D>
struct FlashTiles {
  float q[BQ][D + 1];             // +1: conflict-free reads across rows
  float k[BK][D + 1];
  float v[BK][D];
  float p[BQ][BK + 1];
};

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ src,
                                         float* f) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC; ++i) f[i] = rt::to_f(e[i]);
}

// Max and sum over the 16 lanes that share a row group (lanes 0-15 or
// 16-31 of the warp): xor offsets below 16 stay inside the half.
__device__ __forceinline__ float half_max(float v) {
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float half_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(FT)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ out, int hq, int hkv,
              int tq, int tk, float scale, int causal, int has_window,
              int window) {
  constexpr int VEC = 16 / sizeof(T);   // elements per 16-byte load
  constexpr int CH = D / VEC;           // 16-byte loads per row
  constexpr int DC = D / 16;            // output columns per thread
  extern __shared__ __align__(16) unsigned char smem[];
  FlashTiles<D>& sm = *reinterpret_cast<FlashTiles<D>*>(smem);

  const int bh = blockIdx.x;            // b * hq + h
  const int b = bh / hq, h = bh % hq;
  const int kvh = h / (hq / hkv);
  const int q0 = blockIdx.y * BQ;
  const int nq = min(BQ, tq - q0);
  const int off = tk - tq;              // query i sits at key i + off
  const size_t qbase = static_cast<size_t>(bh) * tq * D;
  const size_t kbase = (static_cast<size_t>(b) * hkv + kvh) * tk * D;
  const int tid = threadIdx.x;
  const int rg = tid / 16;              // rows rg + 8·i
  const int kl = tid % 16;              // keys kl + 16·j, columns kl + 16·c

  // Keys any row of the tile may attend: [lo, hi).
  int lo = 0, hi = tk;
  if (causal) hi = min(tk, q0 + nq + off);
  if (has_window) lo = max(0, q0 + off - window + 1);

  for (int i = tid; i < BQ * CH; i += FT) {
    const int r = i / CH, part = i % CH;
    float f[VEC];
    if (r < nq) {
      load_vec<T, VEC>(q + qbase + static_cast<size_t>(q0 + r) * D +
                           part * VEC, f);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) sm.q[r][part * VEC + e] = f[e];
  }

  float m[RPT], l[RPT], acc[RPT][DC];
  int qi[RPT];
  bool on[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
    qi[i] = q0 + rg + 8 * i + off;
    on[i] = rg + 8 * i < nq;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  for (int t0 = lo; t0 < hi; t0 += BK) {
    for (int i = tid; i < BK * CH; i += FT) {
      const int c = i / CH, part = i % CH, t = t0 + c;
      float kf[VEC], vf[VEC];
      if (t < hi) {
        const size_t o = kbase + static_cast<size_t>(t) * D + part * VEC;
        load_vec<T, VEC>(k + o, kf);
        load_vec<T, VEC>(v + o, vf);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kf[e] = vf[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        sm.k[c][part * VEC + e] = kf[e];
        sm.v[c][part * VEC + e] = vf[e];
      }
    }
    __syncthreads();

    float s[RPT][KPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[RPT], kv[KPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = sm.q[rg + 8 * i][d];
#pragma unroll
      for (int j = 0; j < KPT; ++j) kv[j] = sm.k[kl + 16 * j][d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < KPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    float alpha[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int t = t0 + kl + 16 * j;
        const bool live = on[i] && t < hi && (!causal || t <= qi[i]) &&
                          (!has_window || t >= qi[i] - window + 1);
        s[i][j] = live ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float mn = fmaxf(m[i], half_max(mx));
      alpha[i] = m[i] == -INFINITY ? 0.f : expf(m[i] - mn);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const float p = mn == -INFINITY ? 0.f : expf(s[i][j] - mn);
        sm.p[rg + 8 * i][kl + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * alpha[i] + half_sum(sum);
      m[i] = mn;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha[i];
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = sm.p[rg + 8 * i][c];
#pragma unroll
      for (int cc = 0; cc < DC; ++cc) {
        const float vv = sm.v[c][kl + 16 * cc];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][cc] = fmaf(pv[i], vv, acc[i][cc]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    if (!on[i]) continue;
    const float li = fmaxf(l[i], 1e-30f);
    T* o = out + qbase + static_cast<size_t>(q0 + rg + 8 * i) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) o[kl + 16 * c] = rt::from_f<T>(acc[i][c] / li);
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* out, int b,
             int hq, int hkv, int tq, int tk, float scale, int causal,
             int has_window, int window, cudaStream_t stream) {
  constexpr int smem = static_cast<int>(sizeof(FlashTiles<D>));
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(b * hq, (tq + BQ - 1) / BQ);
  flash_fwd<T, D><<<grid, FT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), hq, hkv, tq, tk, scale,
      causal, has_window, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int hq, int hkv, int tq, int tk, int d, float scale, int causal,
           int has_window, int window, cudaStream_t stream) {
  if (b == 0 || tq == 0) return 0;
  switch (d) {
#define FA_CASE(HD)                                                        \
  case HD:                                                                 \
    return launch_d<T, HD>(q, k, v, out, b, hq, hkv, tq, tk, scale, causal, \
                           has_window, window, stream);
    FA_CASE(16) FA_CASE(32) FA_CASE(48) FA_CASE(64)
    FA_CASE(80) FA_CASE(96) FA_CASE(112) FA_CASE(128)
#undef FA_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; d a multiple of 16 up to 128; window
// counts only where has_window.  Returns cudaGetLastError() after the
// launch (0 on success), cudaErrorInvalidValue for an unsupported dtype or
// head_dim.  Tk == 0 writes zeros (no live key).
extern "C" int flash_attention(int dtype, const void* q, const void* k,
                               const void* v, void* out, int b, int hq,
                               int hkv, int tq, int tk, int d, float scale,
                               int causal, int has_window, int window,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, out, b, hq, hkv, tq, tk, d, scale, causal,
                         has_window, window, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, out, b, hq, hkv, tq, tk, d, scale,
                                 causal, has_window, window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
