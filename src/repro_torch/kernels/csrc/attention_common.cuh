// Shared pieces of the Hopper attention kernels (sm_90a); linear_scan.cu
// takes its element conversions and rt_error_string from here too.
//
// attend(): one block walks the keys of one (row, KV head) for up to QR
// query rows (a GQA group times a query tile), tile by tile:
//   1. gather KT keys and values token by token through an addressing
//      functor (a block table for the paged pools, a stride for the dense
//      cache) into shared memory as float, 16 bytes a thread per load
//      (RawKV below);
//   2. score every (query row, key) pair in float32, masking keys past the
//      query's position and outside the window;
//   3. online softmax, one warp per query row (running max, sum, rescale);
//   4. accumulate P·V in registers, QR·D/NT accumulators per thread.
// The tiles live in static shared memory up to head_dim 128 (42 KB); at
// head_dim 256 (82 KB, past the 48 KB static limit) they move to dynamic
// shared memory, which the launch must opt into (opt_in<D>, then
// dynamic_smem<D>() bytes).
// Nothing of the walk is split across blocks, so no cross-block reduction
// is needed.  The span / token writes of the paged kernels are their own
// launch (write_tokens), ordered before the walk on the stream: every key a
// query may read is resident before any block reads it, as in the oracle.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace rt {

constexpr int NT = 128;  // threads per block
constexpr int QR = 16;   // query rows per block
constexpr int KT = 32;   // keys per tile (one warp lane per key)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Element offset of key t (same for the K and V tensors) in a page pool
// [P, Hkv, ps, D] through one row's block table; -1 entries read page 0.
struct PagedKeys {
  const int* bt_row;
  int hkv, h, ps, d;
  // Pool row of key t: its index in a [P, Hkv, ps] scale pool.
  __device__ __forceinline__ size_t row(int t) const {
    int page = bt_row[t / ps];
    if (page < 0) page = 0;
    return (static_cast<size_t>(page) * hkv + h) * ps + (t % ps);
  }
  __device__ __forceinline__ size_t off(int t) const { return row(t) * d; }
};

// Element offset of key t in a dense cache [B, Hkv, S, D] for one (b, h).
struct DenseKeys {
  size_t base;
  int d;
  __device__ __forceinline__ size_t off(int t) const {
    return base + static_cast<size_t>(t) * d;
  }
};

// Query rows of one block, filled by the kernel before attend():
//   off[r]  element offset of row r in q and out,
//   pos[r]  the row's absolute query position (keys <= pos are causal),
//   on[r]   false for rows whose output is not defined (j >= span).
struct RowSet {
  long long off[QR];
  int pos[QR];
  int on[QR];
};

// Key/value loader of a float (f32 or bf16) pool or cache: one 16-byte
// load of K and of V per (key, chunk), converted to float.
template <typename T, class Keys>
struct RawKV {
  static constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  const T* __restrict__ kpool;
  const T* __restrict__ vpool;
  Keys keys;
  __device__ __forceinline__ void load(int t, int part, float* kd,
                                       float* vd) const {
    const size_t o = keys.off(t) + part * VEC;
    const uint4 kraw = *reinterpret_cast<const uint4*>(kpool + o);
    const uint4 vraw = *reinterpret_cast<const uint4*>(vpool + o);
    const T* ke = reinterpret_cast<const T*>(&kraw);
    const T* ve = reinterpret_cast<const T*>(&vraw);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      kd[e] = to_f(ke[e]);
      vd[e] = to_f(ve[e]);
    }
  }
};

// The shared-memory tiles of one attend() walk.
template <int D>
struct Tiles {
  float q[QR][D];
  float k[KT][D + 1];                     // +1: conflict-free column reads
  float v[KT][D];
  float p[QR][KT];
  float m[QR], l[QR], a[QR];
};

constexpr size_t STATIC_SMEM = 48 * 1024;  // static shared memory limit

// Dynamic shared memory a kernel walking head_dim D launches with (0: the
// tiles are static).
template <int D>
__host__ __device__ constexpr size_t dynamic_smem() {
  return sizeof(Tiles<D>) <= STATIC_SMEM ? 0 : sizeof(Tiles<D>);
}

// Opt ``kernel`` (a walk over head_dim D) into its dynamic shared memory;
// a no-op where the tiles are static.
template <int D, class K>
cudaError_t opt_in(K kernel) {
  if constexpr (dynamic_smem<D>() == 0) return cudaSuccess;
  else
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(dynamic_smem<D>()));
}

template <int D>
__device__ __forceinline__ Tiles<D>& tiles() {
  if constexpr (dynamic_smem<D>() == 0) {
    __shared__ Tiles<D> t;
    return t;
  } else {
    extern __shared__ __align__(16) unsigned char rt_tiles_smem[];
    return *reinterpret_cast<Tiles<D>*>(rt_tiles_smem);
  }
}

// Output element (row, column) of P·V accumulator ``a`` of thread ``tid``:
// for D <= NT one column over rows NT/D apart, for D > NT the D/NT columns
// NT apart of each row.
template <int D>
__device__ __forceinline__ int acc_row(int tid, int a) {
  if constexpr (D <= NT) return tid / D + a * (NT / D);
  else return a / (D / NT);
}
template <int D>
__device__ __forceinline__ int acc_col(int tid, int a) {
  if constexpr (D <= NT) return tid % D;
  else return (a % (D / NT)) * NT + tid;
}

// attend() over a float pool or cache of q's dtype, keys addressed by
// Keys, loaded by RawKV.
template <typename T, int D, class Keys>
__device__ __forceinline__ void attend(const T* __restrict__ q,
                                       T* __restrict__ out,
                                       const T* __restrict__ kpool,
                                       const T* __restrict__ vpool,
                                       const Keys keys, const RowSet& rows,
                                       const int nrows, const int key_cap,
                                       const float scale, const int window) {
  static_assert((NT % D == 0 || D % NT == 0) && D % 8 == 0,
                "head_dim must divide NT or be a multiple of it");
  using KV = RawKV<T, Keys>;
  const KV kv{kpool, vpool, keys};
  constexpr int VEC = KV::VEC;            // elements per 16-byte load
  static_assert(D % VEC == 0, "head_dim must hold whole 16-byte loads");
  constexpr int CHUNKS = D / VEC;         // 16-byte loads per key row
  constexpr int ACC = QR * D / NT;        // P·V accumulators per thread

  Tiles<D>& sm = tiles<D>();
  auto& q_s = sm.q;
  auto& k_s = sm.k;
  auto& v_s = sm.v;
  auto& p_s = sm.p;
  auto& m_s = sm.m;
  auto& l_s = sm.l;
  auto& a_s = sm.a;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // Key range the block's live rows need: [lo, hi).
  int hi = 0, lo = 0x7fffffff;
  for (int r = 0; r < nrows; ++r) {
    if (rows.on[r]) {
      hi = max(hi, rows.pos[r] + 1);
      lo = min(lo, rows.pos[r]);
    }
  }
  hi = min(hi, key_cap);
  lo = window > 0 ? max(0, lo - window + 1) : 0;

  for (int i = tid; i < QR * D; i += NT) {
    const int r = i / D;
    q_s[r][i % D] = r < nrows ? to_f(q[rows.off[r] + i % D]) : 0.f;
  }
  for (int r = tid; r < QR; r += NT) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }
  float acc[ACC];
#pragma unroll
  for (int a = 0; a < ACC; ++a) acc[a] = 0.f;
  __syncthreads();

  for (int t0 = lo; t0 < hi; t0 += KT) {
    for (int i = tid; i < KT * CHUNKS; i += NT) {
      const int c = i / CHUNKS, part = i % CHUNKS, t = t0 + c;
      float kf[VEC], vf[VEC];
      if (t < hi) {
        kv.load(t, part, kf, vf);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kf[e] = vf[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        k_s[c][part * VEC + e] = kf[e];
        v_s[c][part * VEC + e] = vf[e];
      }
    }
    __syncthreads();

    for (int i = tid; i < nrows * KT; i += NT) {
      const int r = i / KT, c = i % KT, t = t0 + c;
      const int p = rows.pos[r];
      float s = -INFINITY;
      if (rows.on[r] && t < hi && t <= p && (window <= 0 || t > p - window)) {
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) dot += q_s[r][d] * k_s[c][d];
        s = dot * scale;
      }
      p_s[r][c] = s;
    }
    __syncthreads();

    for (int r = warp; r < nrows; r += NT / 32) {
      const float s = p_s[r][lane];
      const float mo = m_s[r];
      const float mn = fmaxf(mo, warp_max(s));
      const float p = mn == -INFINITY ? 0.f : expf(s - mn);
      const float sum = warp_sum(p);
      p_s[r][lane] = p;
      if (lane == 0) {
        const float alpha = mo == -INFINITY ? 0.f : expf(mo - mn);
        m_s[r] = mn;
        l_s[r] = l_s[r] * alpha + sum;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int a = 0; a < ACC; ++a) {
      const int r = acc_row<D>(tid, a), d = acc_col<D>(tid, a);
      if (r < nrows) {
        float x = acc[a] * a_s[r];
#pragma unroll 8
        for (int c = 0; c < KT; ++c) x += p_s[r][c] * v_s[c][d];
        acc[a] = x;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < ACC; ++a) {
    const int r = acc_row<D>(tid, a), d = acc_col<D>(tid, a);
    if (r < nrows) {
      const float l = l_s[r];
      out[rows.off[r] + d] = from_f<T>(l > 0.f ? acc[a] / l : 0.f);
    }
  }
}

// The fused write of the paged kernels, as its own launch: grid (B, Hkv,
// Z), the span's token rows spread over the Z blocks of a (row, head)
// (the decode kernel launches Z = 1), one warp a token, its lanes over the
// K and V row's 16-byte chunks; token j < span[b] of row b (span ==
// nullptr: one token) lands in page bt[b, (start+j)/ps] slot (start+j)%ps.
// Writes to -1 pages and past the table drop.  A bitwise copy: the
// wrapper casts k/v_new to the pool dtype first.
template <typename T>
__global__ void __launch_bounds__(NT)
    write_tokens(T* __restrict__ kp, T* __restrict__ vp,
                 const T* __restrict__ kn, const T* __restrict__ vn,
                 const int* __restrict__ bt, const int* __restrict__ start,
                 const int* __restrict__ span, int c, int d, int hkv, int ps,
                 int maxp) {
  const int b = blockIdx.x, h = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chunks = d * static_cast<int>(sizeof(T)) / 16;
  const int st = start[b];
  const int sp = span == nullptr ? 1 : span[b];
  for (int j = blockIdx.z * (NT / 32) + warp; j < sp;
       j += gridDim.z * (NT / 32)) {
    const int t = st + j;
    if (t >= maxp * ps) continue;           // warp-uniform
    const int page = bt[b * maxp + t / ps];
    if (page < 0) continue;
    const size_t dst =
        ((static_cast<size_t>(page) * hkv + h) * ps + t % ps) * d;
    const size_t src = ((static_cast<size_t>(b) * hkv + h) * c + j) * d;
    for (int i = lane; i < 2 * chunks; i += 32) {
      const int part = i >> 1;
      uint4* to = reinterpret_cast<uint4*>((i & 1 ? vp : kp) + dst) + part;
      *to = reinterpret_cast<const uint4*>((i & 1 ? vn : kn) + src)[part];
    }
  }
}

}  // namespace rt

// Message for a status the entry points return (each library has a copy).
extern "C" const char* rt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dispatch a head_dim known at run time onto the templated kernels (16 to
// 128 on static tiles, 256 on dynamic shared memory: launch with
// rt::dynamic_smem<HD>() after rt::opt_in<HD>).
#define RT_DISPATCH_D(D, ...)                     \
  switch (D) {                                    \
    case 16: { constexpr int HD = 16; __VA_ARGS__; } break;  \
    case 32: { constexpr int HD = 32; __VA_ARGS__; } break;  \
    case 64: { constexpr int HD = 64; __VA_ARGS__; } break;  \
    case 128: { constexpr int HD = 128; __VA_ARGS__; } break; \
    case 256: { constexpr int HD = 256; __VA_ARGS__; } break; \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }
