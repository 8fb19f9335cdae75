// The tensor-core walk of paged attention over a paged KV cache (sm_90a):
// the attend of paged_chunk_attention and paged_decode_attention (bf16
// pools) and of their _quant twins (int8 / e4m3 pools).  The pool is a
// policy of the walk (CodePool, Bf16Pool below); rt::attend
// (attention_common.cuh) stays the walk of float32 pools.  A decode call
// is a chunk of span 1 at pos (span == nullptr: no tensor of ones).
//
// FlashAttention-2 on mma.sync.m16n8k16, blocks of 4 warps for a (batch
// row, KV head), grid (B, Hkv, nsplit):
//   - The block's query rows are the (span position, group head) pairs of
//     its KV head with the heads inner, m = j·group + g; rows m < span·group
//     are live, the rest are written zero at once.  The block walks the
//     live rows 64 at a time (16 a warp), so a span-1 decode row (the
//     group's heads) costs one pass, a 64-row prompt chunk one pass, and
//     no block exists only to write zeros.
//   - q (query dtype T) is copied a pass's rows at a time into shared
//     memory by cp.async (all copies in flight at once) and split into
//     Terms<T>::Q bf16 terms (bf16: the value itself; float32: three terms,
//     hi + mid + lo, float32 in effect); ldmatrix reads the A fragments.
//   - A pass with fewer than 4 live row tiles of 16 (a decode row of MHA
//     has one) splits each key tile between the warps: warp w takes row
//     tile w % nrt and n8 key tiles of part w / nrt (k16 steps: at most
//     KT / 16 parts), keeps its own softmax state, and the parts merge in
//     shared memory after the walk (in part order, the combine formula of
//     split-KV), so a decode row keeps the warps busy.
//   - K and V rows are gathered per key through the block table by
//     cp.async (16 B a copy) into a ring of NST stages of KT keys, so NST -
//     1 tiles' gathers are in flight behind the MMAs (3 stages either way:
//     64 keys for codes, 32 for bf16 rows).  CodePool (int8 / e4m3 codes,
//     one f32 scale a row): the
//     codes are exact in bf16, and the tile being walked is converted once
//     (Codec::quad_bf16) into bf16 K and V tiles that every warp reads.
//     (Fragments built from the bytes by each warp, the first design,
//     converted each byte once a warp: 4 times over in a prompt pass,
//     PERF.md.)  Bf16Pool: a bf16 row is a B fragment's source as it
//     lands, so the ring stage is the tile: no conversion pass, no scale,
//     no extra barrier.  Either way every warp reads the tile by ldmatrix
//     (V transposed) from rows padded to an odd count of 16 B, as
//     flash_fwd_mma reads its tiles.
//   - S = Q K^T, then the score column times scale · log2 e (CodePool:
//     also s_k,t); causal and window masks per element (a key t is live
//     for the row at pos if t <= pos and, with a window, t > pos - window),
//     and tiles outside the pass's [lo, hi) are never gathered.  Online
//     softmax in float32 with exp2f, guarded as flash_fwd_mma's; l sums the
//     float32 p.
//   - O += P V (CodePool: p · s_v,t) with P as Terms<T>::P bf16 terms by
//     truncation (tc::split_trunc: each term the upper 16 bits of what the
//     earlier ones left).  bf16 q: two terms, P to 2^-14 relative, so the
//     float32 O agrees with the plain version's to float32 noise and the
//     one rounding of out to bf16 lands at most one bf16 step from it (P
//     rounded once, the first design, put errors two steps out: PERF.md);
//     float32 q: three, float32 in effect.  A row with no live key gives 0.
//   - Split-KV: B·Hkv blocks alone (64 in the agent trial) left most of
//     the 132 SMs idle and each decode row a serial walk of its key tiles
//     (PERF.md: measured per-tile cycles), so the grid is (B, Hkv, nsplit):
//     a row whose live rows fit one pass splits its keys over the nsplit
//     blocks (ranges of split_len keys, whole key tiles, a plan from shapes
//     alone: paged_chunk_attention_quant.py · split_plan and
//     decode_split_plan, paged_chunk_attention.py · split_plan), each
//     writing a float32 partial (O, m, l) — a split with no live key (all
//     past pos, or all below the window) writes m = -inf, l = 0, O = 0,
//     which the combine weighs 0 — and chunk_combine (a second launch)
//     forms out; longer rows are walked whole by block 0.
//   - head_dim 256 (PaliGemma's one KV head of 256): bf16 pools only, on
//     the Bf16Pool256 policy (PoolAt below).  q and a 3-stage ring of 32
//     keys would come to 135,168 B, one block an SM; 2 stages hold 101,376
//     B, two an SM, and still hold the key parts' merge (67,584 B of ring
//     against 66,048).  A warp's O is 16 x 256 float32, 128 registers a
//     lane.  CodePool at head_dim 256 is not built (float32 q would need
//     274,944 B): the wrappers refuse it (ROADMAP.md queue 2, item 20).
// Footprint (ptxas -v, sm_90a; PERF.md, kernel table rows 1, 2, 4 and 5),
// head_dim 128, P in two terms: Bf16Pool, bf16 q: 168 registers (its cap
// at 3 blocks an SM; 158 with P in one term), no spill, q 17,408 B + a
// 3-stage ring of 32 keys 52,224 B = 69,632 B of dynamic shared memory,
// 3 blocks an SM.  CodePool, bf16 q: 183 registers (167-168 before), no
// spill, 109,056 B, 2 blocks an SM; float32 q (the tests' route) 190,
// 143,872 B, 1.  head_dim 256, Bf16Pool256: PERF.md, kernel table row 2.
#pragma once

#include "mma_common.cuh"
#include "quant_common.cuh"

namespace attend_mma {

using bf16 = __nv_bfloat16;

constexpr int NT = 128;            // threads a block
constexpr int NW = NT / 32;        // warps
constexpr int BR = NW * 16;        // query rows a pass
constexpr float LOG2E = 1.4426950408889634f;

// Pool policies of the walk: how a K/V pool row is stored and tiled, and
// the blocks an SM the walk is built for at head_dim 128 (bf16 q; the
// split plans aim at them).
// CodePool: int8 / e4m3 codes (one byte a value) with an f32 scale a row.
template <class Codec_>
struct CodePool {
  using Codec = Codec_;
  static constexpr bool SCALED = true;
  static constexpr int ELEM = 1;     // bytes a value
  static constexpr int KT = 64;      // keys a tile
  static constexpr int NST = 3;      // ring stages
  static constexpr int BLOCKS = 2;   // blocks an SM (109,056 B each)
};
// Bf16Pool: bf16 rows, no scale.  3 stages of 32 keys (69,632 B) hold 3
// blocks an SM and measured faster than 2 stages of 64 (87,040 B, 2
// blocks): PERF.md.
struct Bf16Pool {
  static constexpr bool SCALED = false;
  static constexpr int ELEM = 2;
  static constexpr int KT = 32;
  static constexpr int NST = 3;
  static constexpr int BLOCKS = 3;
};
// Bf16Pool at head_dim 256: 2 stages of 32 keys (101,376 B), 2 blocks an
// SM.
struct Bf16Pool256 {
  static constexpr bool SCALED = false;
  static constexpr int ELEM = 2;
  static constexpr int KT = 32;
  static constexpr int NST = 2;
  static constexpr int BLOCKS = 2;
};
// The policy the walk runs at head_dim D for pool P.
template <class P, int D>
struct PoolAt {
  using type = P;
};
template <>
struct PoolAt<Bf16Pool, 256> {
  using type = Bf16Pool256;
};

// bf16 terms of q and of p · s_v by the query dtype.
template <typename T>
struct Terms;
template <>
struct Terms<float> {
  static constexpr int Q = 3, P = 3;
};
template <>
struct Terms<__nv_bfloat16> {
  static constexpr int Q = 1, P = 2;
};

// Dynamic shared memory: q terms [Q][BR][D + 8] bf16, the ring
// [NST][K, V][KT] of rows of RS bytes, and for CodePool the scales [NST][K,
// V][KT] and the tile being walked as bf16 [K, V][KT][D + 8].  Rows are
// padded by 16 B (codes) or 8 values (bf16), so the 8 rows an ldmatrix
// phase reads fall in 8 bank groups.  After the walk the ring holds the
// merge of the warps' key parts.
template <int D, int Q, class P>
struct Smem {
  static constexpr int QS = D + 8;
  static constexpr int RS = P::SCALED ? D + 16 : 2 * QS;
  static constexpr int raw_off = Q * BR * QS * 2;
  static constexpr int sc_off = raw_off + P::NST * 2 * P::KT * RS;
  static constexpr int cv_off = sc_off + (P::SCALED ? P::NST * 2 * P::KT * 4
                                                    : 0);
  static constexpr int bytes = cv_off + (P::SCALED ? 2 * P::KT * QS * 2 : 0);
  static_assert(P::NST * 2 * P::KT * RS >= NW * 16 * (D + 2) * 4,
                "the ring holds the merge of the key parts");
};

template <typename T, class P, int D>
__global__ void __launch_bounds__(NT, P::BLOCKS)
    chunk_mma(const T* __restrict__ q, T* __restrict__ out,
              const uint8_t* __restrict__ kp, const uint8_t* __restrict__ vp,
              const float* __restrict__ ks, const float* __restrict__ vs,
              const int* __restrict__ bt, const int* __restrict__ start,
              const int* __restrict__ span, int hq, int hkv, int c, int ps,
              int maxp, float scale_log2, int window,
              float* __restrict__ part_o, float* __restrict__ part_ml,
              int nsplit, int split_len) {
  constexpr int NQ = Terms<T>::Q, NP = Terms<T>::P;
  using L = Smem<D, NQ, P>;
  constexpr int KT = P::KT;        // keys a tile
  constexpr int NK = KT / 8;       // n8 key tiles a tile (S)
  constexpr int NST = P::NST;      // ring stages
  constexpr int KS = D / 16;       // k16 steps over D (S)
  constexpr int ND = D / 8;        // n8 column tiles over D (O)
  constexpr int CH = D * P::ELEM / 16;   // 16-byte copies a row
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  uint8_t* raw = smem + L::raw_off;
  float* sc = reinterpret_cast<float*>(smem + L::sc_off);
  bf16* cv = reinterpret_cast<bf16*>(smem + L::cv_off);   // [2 * KT][QS]

  const int b = blockIdx.x, kvh = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, j4 = lane & 3;
  const int group = hq / hkv;
  const int nrows = c * group;
  // Rows m < live are defined (span == nullptr: the decode form, span 1).
  const int live = (span == nullptr ? 1 : span[b]) * group;
  const int st = start[b], cap = maxp * ps;
  const int* bt_row = bt + static_cast<size_t>(b) * maxp;
  // Element offset of row m in q and out ([B, Hq, C, D]).
  auto row_off = [&](int m) {
    return ((static_cast<size_t>(b) * hq + kvh * group + m % group) * c +
            m / group) * static_cast<size_t>(D);
  };

  constexpr int QV = 16 / sizeof(T);       // elements a 16-byte copy
  // A row of one pass splits its keys over the nsplit blocks of its (row,
  // head); a longer one is walked whole by block 0.
  const int ns = live <= BR ? nsplit : 1;
  if (split >= ns) return;
  const int per = (nsplit + ns - 1) / ns * split_len;     // keys a split
  if (split == 0)
    for (int x = tid; x < (nrows - live) * (D / QV); x += NT)
      *reinterpret_cast<uint4*>(out + row_off(live + x / (D / QV)) +
                                x % (D / QV) * QV) = make_uint4(0, 0, 0, 0);

  // NT / KT threads a key: one table lookup a tile, then alternate
  // 16-byte chunks of its K and its V row (a warp's copies cover whole
  // sectors).
  constexpr int TPK = NT / KT;
  const int lkey = tid / TPK, lpart = tid % TPK;
  for (int m0 = 0; m0 < live; m0 += BR) {
    // Keys the pass's live rows may attend: [lo, hi).
    const int nlive = min(BR, live - m0);
    const int hi = min(min(st + (m0 + nlive - 1) / group + 1, cap),
                       (split + 1) * per);
    const int lo = max(window > 0 ? st + m0 / group - window + 1 : 0,
                       split * per);
    const int ntiles = hi > lo ? (hi - lo + KT - 1) / KT : 0;
    if (ntiles == 0) {
      // No key of the pass in this split (all past pos, or all below the
      // window): an empty partial (m = -inf, l = 0, O = 0), which the
      // combine weighs 0; a row walked whole gives 0.  Nothing else.
      for (int x = tid; x < nlive * D; x += NT) {
        const int m = m0 + x / D, col = x % D;
        if (ns > 1) {
          const size_t prow =
              ((static_cast<size_t>(b) * hkv + kvh) * nsplit + split) *
                  nrows + m;
          part_o[prow * D + col] = 0.f;
          if (col == 0) {
            part_ml[2 * prow] = -INFINITY;
            part_ml[2 * prow + 1] = 0.f;
          }
        } else {
          out[row_off(m) + col] = rt::from_f<T>(0.f);
        }
      }
      continue;
    }
    // Warp roles: nrt row tiles of 16 are live; the warps split each key
    // tile ksplit ways between them, whole k16 steps a part (warp w: row
    // tile wt = w % nrt, key part w / nrt, its n8 key tiles [nlo, nhi)),
    // merged after the walk.
    const int nrt = (nlive + 15) / 16;
    const int ksplit = min(NW / nrt, KT / 16);
    const int wt = warp % nrt, kg = warp / nrt;
    const bool active = kg < ksplit;
    const int nlo = kg * (NK / ksplit), nhi = nlo + NK / ksplit;

    auto load = [&](int stage, int t0) {
      const int t = t0 + lkey;
      const bool in = t < hi;
      int page = in ? bt_row[t / ps] : 0;
      if (page < 0) page = 0;              // -1 entries read page 0
      const size_t row =
          (static_cast<size_t>(page) * hkv + kvh) * ps + (in ? t % ps : 0);
      uint8_t* dst = raw + (stage * 2 * KT + lkey) * L::RS;
      const size_t src = row * D * P::ELEM;
#pragma unroll
      for (int ch = lpart; ch < CH; ch += TPK) {
        tc::cp_async16(dst + ch * 16, kp + src + ch * 16, in);
        tc::cp_async16(dst + KT * L::RS + ch * 16, vp + src + ch * 16, in);
      }
      if constexpr (P::SCALED)
        if (lpart < 2)
          tc::cp_async4(sc + (stage * 2 + lpart) * KT + lkey,
                        (lpart ? vs : ks) + row, in);
    };

    // q rows of the live row tiles (nrt·16 rows; the rest are never read)
    // by 16-byte copies, all in flight at once: bf16 straight into the q
    // tile; float32 into the raw ring, then split into its terms.
    const int qrows = nrt * 16;
    if constexpr (NQ == 1) {
      for (int x = tid; x < qrows * D / QV; x += NT) {
        const int rr = x / (D / QV), col = (x % (D / QV)) * QV;
        const bool in = m0 + rr < live;
        tc::cp_async16(qs + rr * L::QS + col,
                       in ? q + row_off(m0 + rr) + col : q, in);
      }
      tc::cp_async_commit();
    } else {
      T* qraw = reinterpret_cast<T*>(raw);                // [BR][D]
      for (int x = tid; x < qrows * D / QV; x += NT) {
        const int rr = x / (D / QV), col = (x % (D / QV)) * QV;
        const bool in = m0 + rr < live;
        tc::cp_async16(qraw + rr * D + col,
                       in ? q + row_off(m0 + rr) + col : q, in);
      }
      tc::cp_async_commit();
      tc::cp_async_wait<0>();
      __syncthreads();
      for (int x = tid; x < qrows * D; x += NT) {
        const int rr = x / D, col = x % D;
        bf16 t[NQ];
        tc::split_bf16<NQ>(rt::to_f(qraw[x]), t);
#pragma unroll
        for (int i = 0; i < NQ; ++i)
          qs[(i * BR + rr) * L::QS + col] = t[i];
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < NST - 1; ++i) {  // the first NST - 1 tiles
      if (i < ntiles) load(i, lo + i * KT);
      tc::cp_async_commit();
    }

    const int mw = m0 + wt * 16;           // this warp's first row
    bool on[2];
    int pos[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = mw + g + 8 * e;
      on[e] = active && m < live;
      pos[e] = st + m / group;
    }
    float o[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.f, 0.f};

    for (int it = 0; it < ntiles; ++it) {
      const int t0 = lo + it * KT, stg = it % NST;
      if (it + NST - 1 < ntiles)           // the slot tile it - 1 freed
        load((it + NST - 1) % NST, t0 + (NST - 1) * KT);
      tc::cp_async_commit();
      tc::cp_async_wait<NST - 1>();        // tile it has landed
      __syncthreads();
      // The tile's K rows, then its V rows, as bf16 [2·KT][QS]: a bf16
      // pool's ring stage as it landed; codes converted (exactly) once for
      // all warps.
      const bf16* kv =
          reinterpret_cast<const bf16*>(raw + stg * 2 * KT * L::RS);
      if constexpr (P::SCALED) {
        for (int x = tid; x < 2 * KT * CH; x += NT) {
          const int row = x / CH, ch = x % CH;   // row: K rows, then V rows
          const uint4 w = *reinterpret_cast<const uint4*>(
              raw + (stg * 2 * KT + row) * L::RS + ch * 16);
          const uint32_t wv[4] = {w.x, w.y, w.z, w.w};
          uint32_t o8[8];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            P::Codec::quad_bf16(wv[i], o8[2 * i], o8[2 * i + 1]);
          uint4* dst = reinterpret_cast<uint4*>(cv + row * L::QS + ch * 16);
          dst[0] = make_uint4(o8[0], o8[1], o8[2], o8[3]);
          dst[1] = make_uint4(o8[4], o8[5], o8[6], o8[7]);
        }
        __syncthreads();
        kv = cv;
      }
      if (active) {
        const float* skt = sc + stg * 2 * KT;
        const float* svt = skt + KT;

        // S = Q K^T over this warp's n8 key tiles, NQ MMAs a fragment.
        float s[NK][4];
#pragma unroll
        for (int n = 0; n < NK; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
        for (int k = 0; k < KS; ++k) {
          uint32_t af[NQ][4];
#pragma unroll
          for (int i = 0; i < NQ; ++i)
            tc::ldmatrix_x4(af[i], qs + (i * BR + wt * 16 + (lane & 15)) *
                                            L::QS + k * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int n2 = 0; n2 < NK / 2; ++n2) {
            if (2 * n2 < nlo || 2 * n2 >= nhi) continue;
            uint32_t kb[4];
            tc::ldmatrix_x4(kb, kv + (n2 * 16 + (lane & 7) +
                                      ((lane >> 4) << 3)) * L::QS +
                                    k * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
            for (int i = 0; i < NQ; ++i) {
              tc::mma_bf16(s[2 * n2], af[i], kb[0], kb[1]);
              tc::mma_bf16(s[2 * n2 + 1], af[i], kb[2], kb[3]);
            }
          }
        }

        // Scale, mask, online softmax of rows g (e 0, 1) and g + 8 (2, 3).
        float mx[2] = {mrow[0], mrow[1]};
#pragma unroll
        for (int n = 0; n < NK; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kk = n * 8 + 2 * j4 + (e & 1), t = t0 + kk;
            const int rr = e >> 1;
            float x;
            if constexpr (P::SCALED)
              x = s[n][e] * (skt[kk] * scale_log2);
            else
              x = s[n][e] * scale_log2;
            if (!on[rr] || n < nlo || n >= nhi || t >= hi || t > pos[rr] ||
                (window > 0 && t <= pos[rr] - window))
              x = -INFINITY;
            s[n][e] = x;
            mx[rr] = fmaxf(mx[rr], x);
          }
        }
        float mu[2], alpha[2];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const float mn = tc::quad_max(mx[rr]);
          mu[rr] = mn == -INFINITY ? 0.f : mn;   // no live key yet: p = 0
          alpha[rr] = exp2f(mrow[rr] - mu[rr]);
          mrow[rr] = mn;
          lrow[rr] *= alpha[rr];
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
          if (n < nlo || n >= nhi) continue;   // not this warp's keys
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = exp2f(s[n][e] - mu[e >> 1]);
            lrow[e >> 1] += p;
            if constexpr (P::SCALED)
              s[n][e] = p * svt[n * 8 + 2 * j4 + (e & 1)];   // p · s_v,t
            else
              s[n][e] = p;
          }
        }

        // O += P V (codes: P · s_v) over this warp's keys, V by
        // ldmatrix.trans.
#pragma unroll
        for (int kk = 0; kk < KT / 16; ++kk) {
          if (2 * kk < nlo || 2 * kk >= nhi) continue;
          uint32_t p0[NP], p1[NP], p2[NP], p3[NP];
          tc::split_trunc<NP>(s[2 * kk][0], s[2 * kk][1], p0);
          tc::split_trunc<NP>(s[2 * kk][2], s[2 * kk][3], p1);
          tc::split_trunc<NP>(s[2 * kk + 1][0], s[2 * kk + 1][1], p2);
          tc::split_trunc<NP>(s[2 * kk + 1][2], s[2 * kk + 1][3], p3);
#pragma unroll
          for (int n2 = 0; n2 < ND / 2; ++n2) {
            uint32_t vb[4];
            tc::ldmatrix_x4_trans(
                vb, kv + (KT + kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                             L::QS + n2 * 16 + (lane >> 4) * 8);
#pragma unroll
            for (int i = 0; i < NP; ++i) {
              const uint32_t pa[4] = {p0[i], p1[i], p2[i], p3[i]};
              tc::mma_bf16(o[2 * n2], pa, vb[0], vb[1]);
              tc::mma_bf16(o[2 * n2 + 1], pa, vb[2], vb[3]);
            }
          }
        }
      }
      __syncthreads();                     // the ring slot is free again
    }

    // The key parts of a row tile meet in the (now free) raw ring: part kg
    // writes (m, l, O) of its live rows, part 0 merges them in part order.
    float* mo = reinterpret_cast<float*>(raw);   // [NW][16][D]
    float* ml = mo + NW * 16 * D;                // [NW][16][2]
#pragma unroll
    for (int e = 0; e < 2; ++e) lrow[e] = tc::quad_sum(lrow[e]);
    if (ksplit > 1 && active) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int rr = g + 8 * e;
        if (mw + rr >= live) continue;
        float* dst = mo + (warp * 16 + rr) * D + 2 * j4;
#pragma unroll
        for (int n = 0; n < ND; ++n)
          *reinterpret_cast<float2*>(dst + n * 8) =
              make_float2(o[n][2 * e], o[n][2 * e + 1]);
        if (j4 == 0) {
          ml[(warp * 16 + rr) * 2] = mrow[e];
          ml[(warp * 16 + rr) * 2 + 1] = lrow[e];
        }
      }
    }
    __syncthreads();
    if (active && kg == 0) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int rr = g + 8 * e, m = mw + rr;
        if (m >= live) continue;
        float l = lrow[e];
        if (ksplit > 1) {
          float mmax = -INFINITY;
          for (int k = 0; k < ksplit; ++k)
            mmax = fmaxf(mmax, ml[((k * nrt + wt) * 16 + rr) * 2]);
          l = 0.f;
#pragma unroll
          for (int n = 0; n < ND; ++n) o[n][2 * e] = o[n][2 * e + 1] = 0.f;
          for (int k = 0; k < ksplit; ++k) {
            const int w = k * nrt + wt;
            const float mk = ml[(w * 16 + rr) * 2];
            if (mk == -INFINITY) continue;
            const float a = exp2f(mk - mmax);
            l += a * ml[(w * 16 + rr) * 2 + 1];
            const float* src = mo + (w * 16 + rr) * D + 2 * j4;
#pragma unroll
            for (int n = 0; n < ND; ++n) {
              const float2 v = *reinterpret_cast<const float2*>(src + n * 8);
              o[n][2 * e] += a * v.x;
              o[n][2 * e + 1] += a * v.y;
            }
          }
        }
        if (ns > 1) {                      // the split's partial (O, m, l)
          const size_t prow =
              ((static_cast<size_t>(b) * hkv + kvh) * nsplit + split) *
                  nrows + m;
          float* dst = part_o + prow * D + 2 * j4;
#pragma unroll
          for (int n = 0; n < ND; ++n)
            *reinterpret_cast<float2*>(dst + n * 8) =
                make_float2(o[n][2 * e], o[n][2 * e + 1]);
          if (j4 == 0) {
            float mk = mrow[e];
            if (ksplit > 1) {
              mk = -INFINITY;
              for (int k = 0; k < ksplit; ++k)
                mk = fmaxf(mk, ml[((k * nrt + wt) * 16 + rr) * 2]);
            }
            part_ml[2 * prow] = mk;
            part_ml[2 * prow + 1] = l;
          }
          continue;
        }
        const float inv = l > 0.f ? 1.f / l : 0.f;
        T* dst = out + row_off(m) + 2 * j4;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          dst[n * 8] = rt::from_f<T>(o[n][2 * e] * inv);
          dst[n * 8 + 1] = rt::from_f<T>(o[n][2 * e + 1] * inv);
        }
      }
    }
    tc::cp_async_wait<0>();                // (the trailing empty groups)
    __syncthreads();                       // the raw ring and q terms are
                                           // rebuilt next pass
  }
}

// out of the rows whose keys were split: grid (B·Hkv, ceil(C·group / 4)),
// a warp a row: out = sum 2^(m_i - M)·O_i / sum 2^(m_i - M)·l_i over the
// splits with a live key, M = max m_i (0 where none has one).  span ==
// nullptr: the decode form (C 1), grid (B·Hkv, ceil(group / 4)).  CPL:
// the columns a lane takes, d <= 32·CPL.
template <typename T, int CPL>
__global__ void __launch_bounds__(NT)
    chunk_combine(T* __restrict__ out, const float* __restrict__ part_o,
                  const float* __restrict__ part_ml,
                  const int* __restrict__ span, int hq, int hkv, int c,
                  int d, int nsplit) {
  const int bh = blockIdx.x, b = bh / hkv, kvh = bh % hkv;
  const int group = hq / hkv, nrows = c * group;
  const int m = blockIdx.y * NW + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  const int live = (span == nullptr ? 1 : span[b]) * group;
  if (live > BR || m >= live) return;      // walked whole, or past the span
  const size_t p0 = static_cast<size_t>(bh) * nsplit * nrows + m;
  // Lane s holds split s's weight 2^(m_s - M) (nsplit <= 32).
  const float mi = lane < nsplit ? part_ml[2 * (p0 + lane * nrows)] : -INFINITY;
  const float li = lane < nsplit ? part_ml[2 * (p0 + lane * nrows) + 1] : 0.f;
  const float mmax = rt::warp_max(mi);
  const float w = mi == -INFINITY ? 0.f : exp2f(mi - mmax);
  const float lsum = rt::warp_sum(w * li);
  const float inv = lsum > 0.f ? 1.f / lsum : 0.f;
  T* dst = out + ((static_cast<size_t>(b) * hq + kvh * group + m % group) *
                      c + m / group) * d;
  // Each lane's columns lane + 32k; the loads of 8 splits in flight.
  float acc[CPL] = {};
  for (int s0 = 0; s0 < nsplit; s0 += 8) {
    float v[8][CPL];
#pragma unroll
    for (int u = 0; u < 8; ++u)
#pragma unroll
      for (int k = 0; k < CPL; ++k) {
        const int col = lane + 32 * k;
        v[u][k] = s0 + u < nsplit && col < d
                      ? part_o[(p0 + (s0 + u) * nrows) * d + col]
                      : 0.f;
      }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const float wu = __shfl_sync(0xffffffffu, w, (s0 + u) & 31);
#pragma unroll
      for (int k = 0; k < CPL; ++k)
        acc[k] += (s0 + u < nsplit ? wu : 0.f) * v[u][k];
    }
  }
#pragma unroll
  for (int k = 0; k < CPL; ++k)
    if (lane + 32 * k < d) dst[lane + 32 * k] = rt::from_f<T>(acc[k] * inv);
}

// One launch of the walk at head_dim D on policy P (its dynamic shared
// memory opted into first); returns the CUDA status.
template <typename T, class P, int D>
cudaError_t walk(const void* q, void* out, const void* kp, const void* vp,
                 const float* ks, const float* vs, const int* bt,
                 const int* start, const int* span, float* part_o,
                 float* part_ml, int b, int hq, int hkv, int c, int ps,
                 int maxp, float scale, int window, int nsplit,
                 int split_len, cudaStream_t stream) {
  if (split_len % P::KT) return cudaErrorInvalidValue;
  constexpr int bytes = Smem<D, Terms<T>::Q, P>::bytes;
  const cudaError_t err = cudaFuncSetAttribute(
      chunk_mma<T, P, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  chunk_mma<T, P, D><<<dim3(b, hkv, nsplit), NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<T*>(out),
      static_cast<const uint8_t*>(kp), static_cast<const uint8_t*>(vp), ks,
      vs, bt, start, span, hq, hkv, c, ps, maxp, scale * LOG2E, window,
      part_o, part_ml, nsplit, split_len);
  return cudaGetLastError();
}

// The walk (and, with several splits, the combine) over pools of policy P
// for query dtype T; returns the CUDA status.  ks / vs: the row scales of a
// CodePool (a Bf16Pool takes none).  start / span: i32[B]; span ==
// nullptr is the decode form (c == 1, start = pos).  part: float32 scratch
// of B·Hkv·nsplit·C·group·(D + 2) when nsplit > 1 (O partials, then (m, l)
// pairs); the split (nsplit ranges of split_len keys, whole key tiles) is
// the caller's plan's.  head_dim 16-128, and 256 on a Bf16Pool.
template <typename T, class P>
int attend(const void* q, void* out, const void* kp, const void* vp,
           const float* ks, const float* vs, const int* bt, const int* start,
           const int* span, float* part, int b, int hq, int hkv, int c, int d,
           int ps, int maxp, float scale, int window, int nsplit,
           int split_len, cudaStream_t stream) {
  if (nsplit < 1 || nsplit > 32 || (nsplit > 1 && part == nullptr) ||
      (span == nullptr && c != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t nrows = static_cast<size_t>(c) * (hq / hkv);
  float* part_o = part;
  float* part_ml =
      part == nullptr ? nullptr
                      : part + static_cast<size_t>(b) * hkv * nsplit * nrows * d;
  cudaError_t err;
  switch (d) {
#define AM_CASE(HD)                                                        \
  case HD:                                                                 \
    err = walk<T, typename PoolAt<P, HD>::type, HD>(                       \
        q, out, kp, vp, ks, vs, bt, start, span, part_o, part_ml, b, hq,   \
        hkv, c, ps, maxp, scale, window, nsplit, split_len, stream);       \
    break;
    AM_CASE(16) AM_CASE(32) AM_CASE(64) AM_CASE(128)
#undef AM_CASE
    case 256:
      if constexpr (P::SCALED) {
        return static_cast<int>(cudaErrorInvalidValue);
      } else {
        err = walk<T, typename PoolAt<P, 256>::type, 256>(
            q, out, kp, vp, ks, vs, bt, start, span, part_o, part_ml, b, hq,
            hkv, c, ps, maxp, scale, window, nsplit, split_len, stream);
      }
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess || nsplit == 1) return static_cast<int>(err);
  const dim3 grid(b * hkv, static_cast<unsigned>((nrows + NW - 1) / NW));
  if (d > 128)
    chunk_combine<T, 8><<<grid, NT, 0, stream>>>(
        static_cast<T*>(out), part_o, part_ml, span, hq, hkv, c, d, nsplit);
  else
    chunk_combine<T, 4><<<grid, NT, 0, stream>>>(
        static_cast<T*>(out), part_o, part_ml, span, hq, hkv, c, d, nsplit);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace attend_mma
