// Shared pieces of the four paged-MLA Hopper kernels (sm_90a).
//
// A latent page pool [P, ps, Dp] holds one row concat([ckv; krope]) per
// token in its first L = r + rd features (Dp is padded to a multiple of
// 128 at init).  The row is both the key (its L live features) and the
// value (its first r): every head and every span query of a batch row
// scores the same rows, so MLA is multi-query attention with H·C query
// rows per latent row.
//
// attend(): one block walks the rows of one batch row for up to QR query
// rows (a tile of the H·C (head, span query) pairs), tile by tile:
//   1. gather KT latent rows token by token through the block table into
//      shared memory as float, 16 bytes a thread per load (the loader
//      dequantizes a quantized pool there); a load may cover pad columns
//      of the row, which are not stored and never scored;
//   2. each warp scores RPW query rows against the tile, one lane per key,
//      over the L live features, and updates those rows' online softmax;
//   3. each thread accumulates P·V for RV value columns of all QR rows in
//      registers, reading the same tile (V is a prefix of K).
// q and ctx are float32.  Shared memory is dynamic: a q tile of QR·L
// floats and a key tile of KT·LS floats (LS odd, for conflict-free column
// reads) — 113 KB at L = 576, past the 48 KB of static shared memory.
// The span / token writes are their own launch, ordered before the walk on
// the stream (write_latent, write_latent_quant): every row a query may
// read is resident before any block reads it, as in the plain version.
#pragma once

#include "quant_common.cuh"

namespace mla {

using rt::KT;
using rt::NT;
using rt::QR;
constexpr int WARPS = NT / 32;
constexpr int RPW = QR / WARPS;  // query rows each warp scores

// Query rows of one block: element offsets in q ([..., L]) and ctx
// ([..., r]), absolute positions (rows <= pos attend), and whether the
// row's output is defined (j < span).
struct Rows {
  long long q[QR];
  long long o[QR];
  int pos[QR];
  int on[QR];
};

// Odd row stride of the key tile.
__host__ __device__ __forceinline__ int tile_stride(int L) {
  return L + 1 - (L & 1);
}

inline size_t smem_bytes(int L) {
  return sizeof(float) *
         (static_cast<size_t>(QR) * L + static_cast<size_t>(KT) *
          tile_stride(L) + QR * KT + 3 * QR);
}

// Loader of a float (f32 or bf16) latent pool: chunk ``part`` of row t.
template <typename T>
struct RawRow {
  static constexpr int VEC = 16 / sizeof(T);
  const T* __restrict__ pool;
  rt::PagedKeys keys;  // hkv = 1, h = 0, d = Dp
  __device__ __forceinline__ void load(int t, int part, float* dst) const {
    const uint4 raw =
        *reinterpret_cast<const uint4*>(pool + keys.off(t) + part * VEC);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) dst[i] = rt::to_f(e[i]);
  }
};

// Loader of an int8 / fp8 latent pool with f32 row scales [P, ps]: each
// value times its row's scale, the product dequantize_rows forms.
template <class Codec>
struct QuantRow {
  using S = typename Codec::S;
  static constexpr int VEC = 16;
  const S* __restrict__ pool;
  const float* __restrict__ scales;
  rt::PagedKeys keys;
  __device__ __forceinline__ void load(int t, int part, float* dst) const {
    const size_t row = keys.row(t);
    const float s = scales[row];
    const uint4 raw = *reinterpret_cast<const uint4*>(
        pool + row * keys.d + part * VEC);
    const S* e = reinterpret_cast<const S*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) dst[i] = Codec::dequant(e[i]) * s;
  }
};

template <int RV, class Loader>
__device__ __forceinline__ void attend(const float* __restrict__ q,
                                       float* __restrict__ ctx,
                                       const Loader ld, const Rows& rows,
                                       const int nrows, const int key_cap,
                                       const int r, const int L,
                                       const float scale) {
  extern __shared__ float smem[];
  const int LS = tile_stride(L);
  float* q_s = smem;                 // [QR][L]
  float* k_s = q_s + QR * L;         // [KT][LS]
  float* p_s = k_s + KT * LS;        // [QR][KT]
  float* m_s = p_s + QR * KT;        // running max, sum, rescale per row
  float* l_s = m_s + QR;
  float* a_s = l_s + QR;
  constexpr int VEC = Loader::VEC;
  const int chunks = (L + VEC - 1) / VEC;  // loads per row
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  int hi = 0;
  for (int i = 0; i < nrows; ++i)
    if (rows.on[i]) hi = max(hi, rows.pos[i] + 1);
  hi = min(hi, key_cap);

  for (int i = tid; i < QR * L; i += NT) {
    const int rr = i / L;
    q_s[i] = rr < nrows ? q[rows.q[rr] + i % L] : 0.f;
  }
  for (int i = tid; i < QR; i += NT) {
    m_s[i] = -INFINITY;
    l_s[i] = 0.f;
  }
  float acc[QR][RV];
#pragma unroll
  for (int i = 0; i < QR; ++i)
#pragma unroll
    for (int k = 0; k < RV; ++k) acc[i][k] = 0.f;
  __syncthreads();

  for (int t0 = 0; t0 < hi; t0 += KT) {
    for (int i = tid; i < KT * chunks; i += NT) {
      const int c = i / chunks, part = i % chunks, t = t0 + c;
      float v[VEC];
      if (t < hi) {
        ld.load(t, part, v);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) v[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int col = part * VEC + e;
        if (col < L) k_s[c * LS + col] = v[e];
      }
    }
    __syncthreads();

    // Scores of this warp's rows against key t0 + lane, then their online
    // softmax (a row's max, sum and rescale belong to one warp).
    {
      const int t = t0 + lane;
      const float* kr = k_s + lane * LS;
      float dot[RPW];
#pragma unroll
      for (int i = 0; i < RPW; ++i) dot[i] = 0.f;
#pragma unroll 4
      for (int d = 0; d < L; ++d) {
        const float kv = kr[d];
#pragma unroll
        for (int i = 0; i < RPW; ++i)
          dot[i] += q_s[(warp + WARPS * i) * L + d] * kv;
      }
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const int rr = warp + WARPS * i;
        float s = -INFINITY;
        if (rr < nrows && rows.on[rr] && t < hi && t <= rows.pos[rr])
          s = dot[i] * scale;
        const float mo = m_s[rr];
        const float mn = fmaxf(mo, rt::warp_max(s));
        const float p = mn == -INFINITY ? 0.f : expf(s - mn);
        const float sum = rt::warp_sum(p);
        p_s[rr * KT + lane] = p;
        if (lane == 0) {
          const float alpha = mo == -INFINITY ? 0.f : expf(mo - mn);
          m_s[rr] = mn;
          l_s[rr] = l_s[rr] * alpha + sum;
          a_s[rr] = alpha;
        }
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < QR; ++i) {
      const float alpha = a_s[i];
#pragma unroll
      for (int k = 0; k < RV; ++k) acc[i][k] *= alpha;
    }
#pragma unroll 4
    for (int c = 0; c < KT; ++c) {
      float v[RV];
#pragma unroll
      for (int k = 0; k < RV; ++k) {
        const int d = tid + k * NT;
        v[k] = d < r ? k_s[c * LS + d] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < QR; ++i) {
        const float p = p_s[i * KT + c];
#pragma unroll
        for (int k = 0; k < RV; ++k) acc[i][k] += p * v[k];
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < QR; ++i) {
    if (i < nrows) {
      const float l = l_s[i];
#pragma unroll
      for (int k = 0; k < RV; ++k) {
        const int d = tid + k * NT;
        if (d < r) ctx[rows.o[i] + d] = l > 0.f ? acc[i][k] / l : 0.f;
      }
    }
  }
}

// The block's query rows: blockIdx.y tiles the H·C (head, span query)
// pairs of batch row blockIdx.x, QR at a time.  span == nullptr: one
// query per head at start[b] (decode).
template <int RV, class Loader>
__device__ __forceinline__ void attend_block(
    const float* __restrict__ q, float* __restrict__ ctx, const Loader ld,
    const int* __restrict__ start, const int* __restrict__ span, int h,
    int c, int r, int L, int ps, int maxp, float scale) {
  const int b = blockIdx.x;
  const int r0 = blockIdx.y * QR;
  const int nrows = min(QR, h * c - r0);
  __shared__ Rows rows;
  if (threadIdx.x < nrows) {
    const int rr = r0 + threadIdx.x;
    const int hh = rr / c, j = rr % c;
    const long long base = (static_cast<long long>(b) * h + hh) * c + j;
    rows.q[threadIdx.x] = base * L;
    rows.o[threadIdx.x] = base * r;
    rows.pos[threadIdx.x] = start[b] + j;
    rows.on[threadIdx.x] = j < (span == nullptr ? 1 : span[b]);
  }
  __syncthreads();
  attend<RV>(q, ctx, ld, rows, nrows, maxp * ps, r, L, scale);
}

template <typename T, int RV>
__global__ void __launch_bounds__(NT)
    attend_float(const float* __restrict__ q, float* __restrict__ ctx,
                 const T* __restrict__ pool, const int* __restrict__ bt,
                 const int* __restrict__ start, const int* __restrict__ span,
                 int h, int c, int r, int L, int dp, int ps, int maxp,
                 float scale) {
  const rt::PagedKeys keys{bt + static_cast<size_t>(blockIdx.x) * maxp, 1, 0,
                           ps, dp};
  attend_block<RV>(q, ctx, RawRow<T>{pool, keys}, start, span, h, c, r, L,
                   ps, maxp, scale);
}

template <class Codec, int RV>
__global__ void __launch_bounds__(NT)
    attend_quant(const float* __restrict__ q, float* __restrict__ ctx,
                 const typename Codec::S* __restrict__ pool,
                 const float* __restrict__ scales,
                 const int* __restrict__ bt, const int* __restrict__ start,
                 const int* __restrict__ span, int h, int c, int r, int L,
                 int dp, int ps, int maxp, float scale) {
  const rt::PagedKeys keys{bt + static_cast<size_t>(blockIdx.x) * maxp, 1, 0,
                           ps, dp};
  attend_block<RV>(q, ctx, QuantRow<Codec>{pool, scales, keys}, start, span,
                   h, c, r, L, ps, maxp, scale);
}

// The fused write of the float kernels, as its own launch: grid (B);
// token j < span[b] of row b (span == nullptr: one token at start[b])
// lands in page bt[b, (start+j)/ps] slot (start+j)%ps, the whole Dp row
// (pad columns included) copied 16 bytes at a time; -1 pages and
// positions past the table drop.  latent_new is [B, c, Dp] in the pool's
// dtype (the wrapper casts), so the copy is bitwise.
template <typename T>
__global__ void __launch_bounds__(NT)
    write_latent(T* __restrict__ pool, const T* __restrict__ lnew,
                 const int* __restrict__ bt, const int* __restrict__ start,
                 const int* __restrict__ span, int c, int dp, int ps,
                 int maxp) {
  const int b = blockIdx.x;
  const int vec = 16 / sizeof(T);
  const int chunks = dp / vec;
  const int st = start[b];
  const int sp = span == nullptr ? 1 : span[b];
  for (int i = threadIdx.x; i < sp * chunks; i += NT) {
    const int j = i / chunks, part = i % chunks, t = st + j;
    if (t >= maxp * ps) continue;
    const int page = bt[b * maxp + t / ps];
    if (page < 0) continue;
    const size_t dst =
        (static_cast<size_t>(page) * ps + t % ps) * dp + part * vec;
    const size_t src = (static_cast<size_t>(b) * c + j) * dp + part * vec;
    *reinterpret_cast<uint4*>(pool + dst) =
        *reinterpret_cast<const uint4*>(lnew + src);
  }
}

// The quantizing write of the _quant kernels, as its own launch: grid (B),
// one warp per Dp-wide row (rt::quantize_row: abs-max over the whole row,
// pad columns included, as the plain version's quantize_rows), one f32
// scale per row into scales [P, ps].  latent_new is IT (float32 or bf16)
// [B, c, Dp].
template <typename IT, class Codec>
__global__ void __launch_bounds__(NT)
    write_latent_quant(typename Codec::S* __restrict__ pool,
                       float* __restrict__ scales,
                       const IT* __restrict__ lnew,
                       const int* __restrict__ bt,
                       const int* __restrict__ start,
                       const int* __restrict__ span, int c, int dp, int ps,
                       int maxp) {
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int st = start[b];
  const int sp = span == nullptr ? 1 : span[b];
  for (int j = warp; j < sp; j += WARPS) {
    const int t = st + j;
    if (t >= maxp * ps) continue;           // warp-uniform
    const int page = bt[b * maxp + t / ps];
    if (page < 0) continue;
    const size_t dst = static_cast<size_t>(page) * ps + t % ps;
    const size_t src = (static_cast<size_t>(b) * c + j) * dp;
    rt::quantize_row<Codec>(pool, scales, lnew + src, dst, dp, lane);
  }
}

// Launch one attend instantiation with its dynamic shared memory (opted
// in past 48 KB); returns the CUDA status.
template <class Kernel, class... Args>
int launch_attend(Kernel kernel, int b, int h, int c, int L,
                  cudaStream_t stream, Args... args) {
  const size_t bytes = smem_bytes(L);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(b, (h * c + QR - 1) / QR);
  kernel<<<grid, NT, bytes, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// Float pool (dtype 0 = float32, 1 = bfloat16): the write, then the walk.
// span == nullptr is the decode form (c == 1, start = pos).
template <typename T>
int run_float(const float* q, float* ctx, void* pool, const void* lnew,
              const int* bt, const int* start, const int* span, int b, int h,
              int c, int r, int rd, int dp, int ps, int maxp, float scale,
              cudaStream_t stream) {
  if (b == 0 || c == 0 || h == 0) return 0;
  T* p = static_cast<T*>(pool);
  write_latent<T><<<b, NT, 0, stream>>>(p, static_cast<const T*>(lnew), bt,
                                        start, span, c, dp, ps, maxp);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int L = r + rd;
#define MLA_FLOAT(RV)                                                       \
  return launch_attend(attend_float<T, RV>, b, h, c, L, stream, q, ctx,     \
                       static_cast<const T*>(p), bt, start, span, h, c, r, \
                       L, dp, ps, maxp, scale)
  switch ((r + NT - 1) / NT) {
    case 1: MLA_FLOAT(1);
    case 2: MLA_FLOAT(2);
    case 3: MLA_FLOAT(3);
    case 4: MLA_FLOAT(4);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MLA_FLOAT
}

inline int run_float(int dtype, const float* q, float* ctx, void* pool,
                     const void* lnew, const int* bt, const int* start,
                     const int* span, int b, int h, int c, int r, int rd,
                     int dp, int ps, int maxp, float scale,
                     cudaStream_t stream) {
  if (dtype == 0)
    return run_float<float>(q, ctx, pool, lnew, bt, start, span, b, h, c, r,
                            rd, dp, ps, maxp, scale, stream);
  if (dtype == 1)
    return run_float<__nv_bfloat16>(q, ctx, pool, lnew, bt, start, span, b,
                                    h, c, r, rd, dp, ps, maxp, scale,
                                    stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Quantized pool: the quantizing write of latent_new (IT), then the walk.
template <typename IT, class Codec>
int run_quant(const float* q, float* ctx, void* pool, float* scales,
              const void* lnew, const int* bt, const int* start,
              const int* span, int b, int h, int c, int r, int rd, int dp,
              int ps, int maxp, float scale, cudaStream_t stream) {
  using S = typename Codec::S;
  if (b == 0 || c == 0 || h == 0) return 0;
  S* p = static_cast<S*>(pool);
  write_latent_quant<IT, Codec><<<b, NT, 0, stream>>>(
      p, scales, static_cast<const IT*>(lnew), bt, start, span, c, dp, ps,
      maxp);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int L = r + rd;
#define MLA_QUANT(RV)                                                       \
  return launch_attend(attend_quant<Codec, RV>, b, h, c, L, stream, q, ctx, \
                       static_cast<const S*>(p),                            \
                       static_cast<const float*>(scales), bt, start, span,  \
                       h, c, r, L, dp, ps, maxp, scale)
  switch ((r + NT - 1) / NT) {
    case 1: MLA_QUANT(1);
    case 2: MLA_QUANT(2);
    case 3: MLA_QUANT(3);
    case 4: MLA_QUANT(4);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MLA_QUANT
}

// kvdtype: latent_new 0 = float32, 1 = bfloat16; qdtype: pool 0 = int8,
// 1 = fp8-e4m3.
inline int run_quant(int kvdtype, int qdtype, const float* q, float* ctx,
                     void* pool, float* scales, const void* lnew,
                     const int* bt, const int* start, const int* span, int b,
                     int h, int c, int r, int rd, int dp, int ps, int maxp,
                     float scale, cudaStream_t stream) {
#define MLA_RUN(IT, C)                                                       \
  run_quant<IT, C>(q, ctx, pool, scales, lnew, bt, start, span, b, h, c, r, \
                   rd, dp, ps, maxp, scale, stream)
  RT_DISPATCH_QUANT(kvdtype, qdtype, MLA_RUN);
#undef MLA_RUN
}

}  // namespace mla
