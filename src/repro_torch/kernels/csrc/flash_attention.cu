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
// Two routes, one per dtype.  Both mask on the true Tq and Tk (nothing is
// padded), skip key tiles outside every row's causal or window range, keep
// the row statistics (running max m, sum l) and the output accumulator in
// float32 registers, and finish with out = acc / max(l, 1e-30), as the TPU
// kernel's finalize: a query row with no live key (causal with Tq > Tk, or
// a window that empties it) gives 0 (l and acc stay 0) where the plain
// version gives NaN.
//
// bfloat16, flash_fwd_mma (tensor cores, FlashAttention-2's layout on
// mma.sync): a block of 4 warps owns 64 query rows of one (b, h), 16 rows
// a warp; grid (ceil(Tq/64), B·Hq), 1,128 blocks at whisper's shape.
//   - Shared memory holds bf16 tiles: Q once, and K and V tiles of 64 keys
//     in a two-stage ring fed by cp.async (16 B a thread), so the copy of
//     tile i+1 overlaps the math of tile i.  Rows past Tq / Tk are
//     zero-filled through cp.async's src-size operand and masked.  Each row
//     is padded by 16 B, so the 8 rows an ldmatrix phase reads start in 8
//     different 16-byte bank groups (row stride 2·D + 16 bytes).  45 KB at
//     D 64, 85 KB at D 128, dynamic shared memory.
//   - S = QK^T with mma.sync.m16n8k16 bf16 -> f32: Q fragments are read
//     by ldmatrix once a block and stay in registers; K by ldmatrix
//     (non-transposed: a K row is a column of the B operand).
//   - Softmax in registers on scores times scale·log2(e), with exp2f.  A
//     thread holds two rows (lane/4 and lane/4 + 8 of its warp's 16): row
//     max and sum reduce over the 4 lanes of a quad with two shuffles.
//     exp2 of (-inf) - (-inf) is guarded by taking 0 as the max of a row
//     with no live key so far.
//   - O += P·V: P is rounded to bf16 in registers and used as the A
//     operand (the C fragments of two n8 key tiles are the A fragment of
//     one k16 step); V through ldmatrix.trans.  l sums the float32 p.
//     P in bf16 is what the Pallas kernel's MXU takes too; its rounding
//     (at most 2^-9 relative a weight) sits inside the bf16 rule.
//   - O: D/2 float32 accumulators a thread (64 at D 128).
//   ptxas -v (sm_90a, -O3; build.FLAGS passes it): 82 / 96 / 128 / 129 /
//   134 / 166 / 170 / 172 registers at D 16 / 32 / ... / 128, no spill; at
//   D 64 that allows 3 blocks an SM (capping it at 128 for a 4th spilled
//   24 bytes and was not faster on the H100).
//
// float32, flash_fwd (FMAs: tensor cores would take float32 through TF32,
// which cannot hold the float32 tolerance of 1e-5): one block of 128
// threads per (b·Hq, tile of 32 query rows), walking the keys the tile
// needs in tiles of 64.  Each tile of K and V is staged in shared memory
// as float; every thread owns a 4 × 4 block of scores (4 query rows 8
// apart, 4 keys 16 apart) and the same 4 rows × D/16 columns of the
// output; the row statistics reduce across the 16 lanes sharing the rows
// with shuffles.  The tiles take 49 KB at D 64 and 89 KB at D 128;
// ptxas: 63-80 registers, no spill.
#include "attention_common.cuh"
#include "mma_common.cuh"

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

// -- bfloat16: flash_fwd_mma on tensor cores ---------------------------------

constexpr int MT = 128;           // threads per block: 4 warps
constexpr int MQ = 64;            // query rows per block, 16 a warp
constexpr int MK = 64;            // keys per tile
constexpr int PAD = 8;            // bf16 padding a row: 16 bytes
constexpr float LOG2E = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

template <int D>
struct MmaTiles {
  bf16 q[MQ][D + PAD];
  bf16 k[2][MK][D + PAD];         // two-stage ring
  bf16 v[2][MK][D + PAD];
};

using namespace tc;       // cp.async, ldmatrix, mma_bf16 (mma_common.cuh)

template <int D>
__global__ void __launch_bounds__(MT)
    flash_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ out, int hq,
                  int hkv, int tq, int tk, float scale_log2, int causal,
                  int has_window, int window) {
  constexpr int CH = D / 8;       // 16-byte chunks a row
  constexpr int KS = D / 16;      // k16 steps over D (QK^T)
  constexpr int NK = MK / 8;      // n8 key tiles a key tile (S)
  constexpr int ND = D / 8;       // n8 column tiles over D (O)
  extern __shared__ __align__(16) unsigned char smem[];
  MmaTiles<D>& sm = *reinterpret_cast<MmaTiles<D>*>(smem);

  const int bh = blockIdx.y;      // b * hq + h
  const int b = bh / hq, h = bh % hq;
  const int kvh = h / (hq / hkv);
  const int q0 = blockIdx.x * MQ;
  const int nq = min(MQ, tq - q0);
  const int off = tk - tq;        // query i sits at key i + off
  const size_t qbase = static_cast<size_t>(bh) * tq * D;
  const size_t kbase = (static_cast<size_t>(b) * hkv + kvh) * tk * D;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, j4 = lane & 3;
  const int qr = q0 + warp * 16 + g;   // this thread's rows: qr, qr + 8

  // Keys any row of the tile may attend: [lo, hi).
  int lo = 0, hi = tk;
  if (causal) hi = min(tk, q0 + nq + off);
  if (has_window) lo = max(0, q0 + off - window + 1);
  const int ntiles = hi > lo ? (hi - lo + MK - 1) / MK : 0;

  auto load_kv = [&](int stage, int t0) {
    for (int i = tid; i < MK * CH; i += MT) {
      const int r = i / CH, c = i % CH, t = t0 + r;
      const bool in = t < hi;
      const size_t o = kbase + static_cast<size_t>(in ? t : 0) * D + c * 8;
      cp_async16(&sm.k[stage][r][c * 8], k + o, in);
      cp_async16(&sm.v[stage][r][c * 8], v + o, in);
    }
  };
  if (ntiles > 0) {
    for (int i = tid; i < MQ * CH; i += MT) {
      const int r = i / CH, c = i % CH;
      const bool in = r < nq;
      cp_async16(&sm.q[r][c * 8],
                 q + qbase + static_cast<size_t>(in ? q0 + r : 0) * D + c * 8,
                 in);
    }
    load_kv(0, lo);
  }
  cp_async_commit();

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  uint32_t qf[KS][4];

  for (int it = 0; it < ntiles; ++it) {
    const int t0 = lo + it * MK;
    const int st = it & 1;
    if (it + 1 < ntiles) {
      load_kv(st ^ 1, t0 + MK);       // the ring slot tile it-1 freed
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        ldmatrix_x4(qf[ks],
                    &sm.q[warp * 16 + (lane & 15)][ks * 16 + (lane >> 4) * 8]);
    }

    // S = Q K^T: 16 rows × 64 keys a warp, in 8 n8 tiles.
    float s[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int n2 = 0; n2 < NK / 2; ++n2) {
        uint32_t kb[4];
        ldmatrix_x4(kb, &sm.k[st][n2 * 16 + (lane & 7) + ((lane >> 4) << 3)]
                                 [ks * 16 + ((lane >> 3) & 1) * 8]);
        mma_bf16(s[2 * n2], qf[ks], kb[0], kb[1]);
        mma_bf16(s[2 * n2 + 1], qf[ks], kb[2], kb[3]);
      }
    }

    // Mask (only tiles that reach past a row's live keys), then the
    // online softmax of rows qr (e 0, 1) and qr + 8 (e 2, 3).
    const bool full = t0 + MK <= tk &&
                      (!causal || t0 + MK - 1 <= q0 + off) &&
                      (!has_window || t0 >= q0 + MQ + off - window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (!full) {
          const int t = t0 + n * 8 + j4 * 2 + (e & 1);
          const int qi = qr + (e >> 1) * 8 + off;
          if (t >= tk || (causal && t > qi) ||
              (has_window && t < qi - window + 1))
            x = -INFINITY;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float mu[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = quad_max(mx[r]);
      mu[r] = mn == -INFINITY ? 0.f : mn;   // no live key yet: p = 0
      alpha[r] = exp2f(m[r] - mu[r]);
      m[r] = mn;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - mu[e >> 1]);
        l[e >> 1] += s[n][e];
      }
    }

    // O += P V: P from the S fragments as bf16, V through ldmatrix.trans.
#pragma unroll
    for (int kk = 0; kk < MK / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n2 = 0; n2 < ND / 2; ++n2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(
            vb, &sm.v[st][kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8]
                         [n2 * 16 + (lane >> 4) * 8]);
        mma_bf16(o[2 * n2], pa, vb[0], vb[1]);
        mma_bf16(o[2 * n2 + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();                  // the ring slot is free for it + 2
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qr + 8 * r;
    if (row >= tq) continue;
    const float inv = 1.f / fmaxf(quad_sum(l[r]), 1e-30f);
    bf16* dst = out + qbase + static_cast<size_t>(row) * D + j4 * 2;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(dst + n * 8) =
          pack_bf16(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
  }
}

template <int D>
int launch_mma_d(const void* q, const void* k, const void* v, void* out,
                 int b, int hq, int hkv, int tq, int tk, float scale,
                 int causal, int has_window, int window,
                 cudaStream_t stream) {
  constexpr int smem = static_cast<int>(sizeof(MmaTiles<D>));
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((tq + MQ - 1) / MQ, b * hq);
  flash_fwd_mma<D><<<grid, MT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), hq, hkv, tq, tk,
      scale * LOG2E, causal, has_window, window);
  return static_cast<int>(cudaGetLastError());
}

int launch_mma(const void* q, const void* k, const void* v, void* out, int b,
               int hq, int hkv, int tq, int tk, int d, float scale,
               int causal, int has_window, int window, cudaStream_t stream) {
  if (b == 0 || tq == 0) return 0;
  switch (d) {
#define FA_CASE(HD)                                                       \
  case HD:                                                                \
    return launch_mma_d<HD>(q, k, v, out, b, hq, hkv, tq, tk, scale,      \
                            causal, has_window, window, stream);
    FA_CASE(16) FA_CASE(32) FA_CASE(48) FA_CASE(64)
    FA_CASE(80) FA_CASE(96) FA_CASE(112) FA_CASE(128)
#undef FA_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32 (flash_fwd), 1 = bfloat16 (flash_fwd_mma); d a
// multiple of 16 up to 128; window counts only where has_window.  Returns
// cudaGetLastError() after the launch (0 on success), cudaErrorInvalidValue
// for an unsupported dtype or head_dim.  Tk == 0 writes zeros (no live
// key).
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
    return launch_mma(q, k, v, out, b, hq, hkv, tq, tk, d, scale, causal,
                      has_window, window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
