// The tensor-core walk of paged MLA over a latent pool (sm_90a): the
// attend of all four paged-MLA kernels on bf16 and int8 / e4m3 pools —
// paged_mla_chunk and paged_mla_decode (Bf16Pool), paged_mla_chunk_quant
// and paged_mla_decode_quant (CodePool).  A decode call is a chunk of span
// 1 at pos (span == nullptr).  The pool is a policy of the walk (CodePool,
// Bf16Pool below); mla::attend_float (mla_common.cuh) stays the walk of
// float32 pools.
//
// MLA is multi-query attention: every head of every span position scores
// the same latent rows concat([ckv; krope]) (L = r + rd live features),
// and the value is the row's first r.  So the MMA rows are (position,
// head) pairs with the heads inner, m = j·H + h, and one block owns one
// m16 tile of them: at H 16 a decode row is one full tile, and every
// latent row a block gathers serves all of its 16 rows.
//
// walk, grid (B, ymax = max(2·tiles, nsplit)), 4 warps:
//   - Rows m < span·H are live (span == nullptr: span 1, the decode
//     form); tiles past them are zeroed by the block of their index.  A
//     row of T live tiles and keys [0, hi) gives each tile ns = min(ymax /
//     T, nsplit, ceil(hi / min_len)) blocks (at least 1), read from start
//     and span on the card: decode rows spread over up to nsplit blocks,
//     prompt chunks over their tiles and the grid's spare blocks; block i
//     walks tile i / ns over the (i % ns)-th run of ceil(hi / ns) keys
//     (whole 32-key runs).  nsplit and min_len come from shapes alone
//     (paged_mla_chunk_quant.py · split_plan for chunks, decode_split_plan
//     for decode: runs of 32 keys, up to 32 splits).
//   - q is read in place from its two parts, q_abs (float32, r wide) and
//     q_rope (QR: float32 or bf16, rd wide), and enters as three bf16
//     terms hi + mid + lo (each remainder exact in float32, the sum within
//     2^-24 of q), built once a block into shared memory ([3][16][L16 + 8]
//     bf16, 56 KB at L 576; ldmatrix reads the A fragments) from 16-byte
//     (bf16 q_rope: 8-byte) loads, six in flight a thread.  That keeps the
//     scores float32 in effect.
//   - Latent rows are gathered through the block table by cp.async (the
//     row's live columns rounded up to 16 bytes, rows padded to an odd
//     count of 16 B so the 8 rows of a fragment fall in 8 bank groups) in
//     a two-stage ring of KT keys: the next tile's gather overlaps this
//     tile's MMAs.
//       CodePool (int8 / e4m3, one f32 scale a row; KT 32, 576 B a row at
//       DeepSeek-V2-Lite, not 2,304 as float): the codes are exact in
//       bf16, and B fragments are built from the bytes (Codec::quad_bf16)
//       as the MMAs need them, no converted tile: each byte is read by one
//       warp (S splits L, P·V splits the columns).  An S step permutes its
//       k order so a fragment is one 4-byte load; V fragments are one
//       ldmatrix.trans of the bytes (a b16 unit = two columns) and byte
//       permutes.
//       Bf16Pool (1,152 B a row): a bf16 row is a B fragment as it lands:
//       S fragments by ldmatrix in natural k order, V fragments by
//       ldmatrix.trans, as flash_fwd_mma reads its tiles; no scale.
//     Columns at or past L (the pool's pad) are zeroed in the S fragment:
//     never scored.
//   - S = Q·K^T on mma.sync.m16n8k16 (bf16 in, float32 accumulators): the
//     warps split the k16 steps over L (warp w takes w, w+4, ...), three
//     MMAs (one a q term) a fragment into three accumulators; the partial
//     scores meet in shared memory and every warp sums the four in the
//     same order, so all hold the same S and the same softmax state.  (8
//     warps, splitting the keys too, measured slower: PERF.md.)
//   - The softmax scale (CodePool: times the row's scale) multiplies the
//     score column after the MMA (s · scale · log2 e); online softmax with
//     exp2f in float32, guarded as flash_fwd_mma's.  l sums the float32 p.
//   - O += P · V (CodePool: (p · s_t) · V, the V scale folded into P: V is
//     the row's first r columns, so s_t is the same scale), P as three
//     bf16 terms by truncation (tc::split_trunc: logic ops, no conversion
//     instructions; two terms left the float32 rule under a 2x margin in
//     the CPU emulation of tests/test_torch_quant_mma.py, three keep it at
//     about 0.2 of it).  Warp w owns value columns 32·(w + 4k): 64
//     accumulators a thread at r = 512.
//   - One split: the block writes ctx = O / l (0 where l = 0 or the row is
//     past the span).  Several: it writes the float32 partial (O, m, l) of
//     each row into scratch, and combine (a second launch, grid (B,
//     tiles, 16): a decode call's is (B, 1, 16)) forms ctx = sum 2^(m_i -
//     M)·O_i / sum 2^(m_i - M)·l_i over the splits with a live key, M =
//     max m_i.
// Shared memory at L 576 (PERF.md, kernel table rows 6-9): q terms
// 56,064 B; CodePool: raw ring 37,888 + scales 256 + score exchange 10,240
// = 104,448 B, ptxas -v (sm_90a) 220 (int8) / 231 (fp8) registers, no
// spill: two blocks an SM.  Bf16Pool: a ring of 16 keys 37,376 + exchange
// 6,144 = 99,584 B, two blocks an SM (32 keys: 141,056 B, one).
#pragma once

#include "mla_common.cuh"
#include "mma_common.cuh"
#include "quant_common.cuh"

namespace mla_mma {

using bf16 = __nv_bfloat16;

constexpr int NT = 128;            // threads a block
constexpr int NW = NT / 32;        // warps
constexpr int ROWS = 16;           // (position, head) rows a block
constexpr int SPLIT_KT = 32;       // a split's keys: whole runs of 32
constexpr int NQ = 3;              // bf16 terms of q
constexpr int NP = 3;              // bf16 terms of p (· s_t)
constexpr int MAX_R = 512;         // value columns
constexpr int NV4 = MAX_R / 32 / NW;   // 32-column value groups a warp
constexpr int MAX_SPLITS = 32;     // the combine's weights: one a lane
constexpr float LOG2E = 1.4426950408889634f;

// Pool policies of the walk (see the note above).  KT: keys a tile (it
// divides SPLIT_KT); BLOCKS: the blocks an SM its shared memory allows at
// L 576.
template <class Codec_>
struct CodePool {                  // int8 / e4m3 codes, f32 row scales
  using Codec = Codec_;
  static constexpr bool CODES = true;
  static constexpr int ELEM = 1, KT = 32, BLOCKS = 2;
};
struct Bf16Pool {                  // bf16 rows
  static constexpr bool CODES = false;
  static constexpr int ELEM = 2, KT = 16, BLOCKS = 2;
};

// Byte offsets of the dynamic shared memory of a walk over L features.
struct Layout {
  int lq;        // L rounded up to 16
  int qs;        // row stride of a q term (bf16 elements): lq + 8
  int rs;        // row stride of a raw latent row (bytes): an odd count of
                 // 16 B, so the 8 rows of a fragment fall in 8 banks
  int raw_off, sc_off, xs_off, bytes;
};

template <class P>
__host__ __device__ inline Layout layout(int L) {
  Layout y;
  y.lq = (L + 15) / 16 * 16;
  y.qs = y.lq + 8;
  y.rs = 16 * ((y.lq * P::ELEM / 16) | 1);
  y.raw_off = NQ * ROWS * y.qs * 2;
  y.sc_off = y.raw_off + 2 * P::KT * y.rs;
  y.xs_off = y.sc_off + (P::CODES ? 2 * P::KT * 4 : 0);
  y.bytes = y.xs_off + NW * ROWS * (P::KT + 8) * 4;
  return y;
}

// Four consecutive q_rope values as float: one 16-byte (float) or 8-byte
// (bf16) load.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x;
  v[1] = f.y;
  v[2] = f.z;
  v[3] = f.w;
}
__device__ __forceinline__ void load4(const bf16* p, float (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

// A bf16 pair's mask: both kept where keep >= 2 columns are live, the low
// (lower-column) half where 1, none where 0.
__device__ __forceinline__ uint32_t pair_mask(int keep) {
  return keep >= 2 ? 0xffffffffu : keep == 1 ? 0x0000ffffu : 0u;
}

constexpr int ROW_BLOCKS = 2;      // grid rows a batch row: 2 a tile

// Blocks (splits) of each live tile of a row with ``tlive`` live tiles and
// keys [0, hi): as many as the row's ``ymax`` grid blocks hold, at most
// ``nsplit``, each split at least ``min_len`` keys.
__host__ __device__ __forceinline__ int row_splits(int tlive, int hi,
                                                   int nsplit, int ymax,
                                                   int min_len) {
  if (tlive <= 0) return 1;
  int ns = ymax / tlive;
  if (ns > nsplit) ns = nsplit;
  const int by_keys = (hi + min_len - 1) / min_len;
  if (ns > by_keys) ns = by_keys;
  return ns > 1 ? ns : 1;
}

// Keys a split of a row's [0, hi) takes: a whole number of 32-key runs.
__host__ __device__ __forceinline__ int split_keys(int hi, int ns) {
  return ((hi + ns - 1) / ns + SPLIT_KT - 1) / SPLIT_KT * SPLIT_KT;
}

// The k order of a CodePool S step: the MMA's k slots 2j, 2j+1, 2j+8, 2j+9
// (a thread's B elements) take latent columns 4j..4j+3 of the 16, so a B
// fragment is one 4-byte load of the raw row; q's terms are stored in the
// same order (column 4j + e of a 16 in slot 2j + (e & 1) + 8·(e >> 1)).
// A Bf16Pool step keeps the natural order.

template <class P, typename QR>
__global__ void __launch_bounds__(NT, P::BLOCKS)
    walk(const float* __restrict__ q_abs, const QR* __restrict__ q_rope,
         float* __restrict__ ctx,
         const uint8_t* __restrict__ pool, const float* __restrict__ scales,
         const int* __restrict__ bt, const int* __restrict__ start,
         const int* __restrict__ span, float* __restrict__ part_o,
         float* __restrict__ part_ml, int h, int c, int r, int L, int dp,
         int ps, int maxp, int nsplit, int min_len, float scale_log2) {
  constexpr int KT = P::KT;        // keys a tile
  constexpr int NK = KT / 8;       // n8 key tiles a tile (S)
  constexpr int XS = KT + 8;       // row stride of the score exchange
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout y = layout<P>(L);
  bf16* qs = reinterpret_cast<bf16*>(smem);             // [NQ][ROWS][qs]
  uint8_t* raw = smem + y.raw_off;                      // [2][KT][rs]
  float* sc = reinterpret_cast<float*>(smem + y.sc_off);   // [2][KT]
  float* xs = reinterpret_cast<float*>(smem + y.xs_off);   // [NW][ROWS][XS]

  const int b = blockIdx.x, blk = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, j4 = lane & 3;
  const int nrows = c * h;
  const int tiles = (nrows + ROWS - 1) / ROWS;
  const int sp = span == nullptr ? 1 : span[b];   // nullptr: decode
  const int live = sp * h;                 // rows m < live are defined
  const int tlive = (live + ROWS - 1) / ROWS;
  const int cap = maxp * ps;
  const int row_hi = min(start[b] + sp, cap);   // the row's keys
  const int ymax = gridDim.y;
  const int ns = row_splits(tlive, row_hi, nsplit, ymax, min_len);
  // Element offset of row m in a [B, H, C, width] tensor: ctx (r), q_abs
  // (r), q_rope (rd).
  auto row_off = [&](int m, int width) {
    return ((static_cast<size_t>(b) * h + m % h) * c + m / h) *
           static_cast<size_t>(width);
  };

  if (blk < tiles && blk >= tlive) {       // a tile past the span: zeros
    const int m0 = blk * ROWS, nr = min(ROWS, nrows - m0);
    for (int rr = 0; rr < nr; ++rr) {
      float* dst = ctx + row_off(m0 + rr, r);
      for (int col = tid; col < r; col += NT) dst[col] = 0.f;
    }
  }
  if (blk >= tlive * ns) return;
  const int tile = blk / ns, split = blk % ns;
  const int m0 = tile * ROWS;
  const int st = start[b];
  // Keys of this block: [k_lo, k_hi), the split's share of the tile's
  // [0, hi) (splits cut the row's [0, row_hi) into equal runs of tiles).
  const int hi = min(st + (min(m0 + ROWS, live) - 1) / h + 1, cap);
  const int per = split_keys(row_hi, ns);
  const int k_lo = split * per;
  const int k_hi = min(hi, k_lo + per);
  const int ntiles = k_hi > k_lo ? (k_hi - k_lo + KT - 1) / KT : 0;
  // 16-byte copies a latent row: its L live columns rounded up, which a
  // pool row of Dp >= L (whole 16-byte loads) always holds.
  const int chunks = (L * P::ELEM + 15) / 16;
  const int* bt_row = bt + static_cast<size_t>(b) * maxp;

  // NT / KT threads a key: one table lookup a tile, then every (NT /
  // KT)-th 16-byte chunk of the row.
  constexpr int TPK = NT / KT;
  const int lkey = tid / TPK, lpart = tid % TPK;
  auto load = [&](int stage, int t0) {
    const int t = t0 + lkey;
    const bool in = t < k_hi;
    int page = in ? bt_row[t / ps] : 0;
    if (page < 0) page = 0;                // -1 entries read page 0
    const size_t row = static_cast<size_t>(page) * ps + (in ? t % ps : 0);
    uint8_t* dst = raw + (stage * KT + lkey) * y.rs;
    const uint8_t* src = pool + row * dp * P::ELEM;
    for (int ch = lpart; ch < chunks; ch += TPK)
      tc::cp_async16(dst + ch * 16, src + ch * 16, in);
    if constexpr (P::CODES)
      if (lpart == 0) tc::cp_async4(sc + stage * KT + lkey, scales + row, in);
  };

  if (ntiles > 0) {
    // q rows from global memory four values a load (q_abs 16 bytes where
    // r is a multiple of 4, q_rope 16 or 8 where rd is too; the wrapper
    // aligns both bases to 16 bytes), QB loads in flight a thread, split
    // into the bf16 terms in registers, two 4-byte stores a term:
    // CodePool's columns 4j..4j+3 of a 16 land in k slots 2j, 2j+1 and
    // 2j+8, 2j+9, Bf16Pool's in their own.
    constexpr int QB = 6;
    const int q4 = y.lq / 4;
    const int rd = L - r;
    const bool vec = (r & 3) == 0 && (rd & 3) == 0;
    for (int x0 = tid; x0 < ROWS * q4; x0 += QB * NT) {
      float v[QB][4];
#pragma unroll
      for (int u = 0; u < QB; ++u) {
        const int x = x0 + u * NT, rr = x / q4, col = 4 * (x % q4);
#pragma unroll
        for (int e = 0; e < 4; ++e) v[u][e] = 0.f;
        if (x < ROWS * q4 && m0 + rr < live) {
          const float* qa = q_abs + row_off(m0 + rr, r);
          const QR* qr = q_rope + row_off(m0 + rr, rd);
          if (vec && col + 4 <= r) {
            const float4 f = *reinterpret_cast<const float4*>(qa + col);
            v[u][0] = f.x;
            v[u][1] = f.y;
            v[u][2] = f.z;
            v[u][3] = f.w;
          } else if (vec && col >= r && col + 4 <= L) {
            load4(qr + col - r, v[u]);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (col + e < r)
                v[u][e] = qa[col + e];
              else if (col + e < L)
                v[u][e] = rt::to_f(qr[col + e - r]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < QB; ++u) {
        const int x = x0 + u * NT, rr = x / q4, col = 4 * (x % q4);
        if (x >= ROWS * q4) continue;
        bf16 t[4][NQ];
#pragma unroll
        for (int e = 0; e < 4; ++e) tc::split_bf16<NQ>(v[u][e], t[e]);
        const int at = rr * y.qs + (P::CODES ? (col & ~15) +
                                               2 * ((col >> 2) & 3)
                                             : col);
        constexpr int HI = P::CODES ? 8 : 2;   // slot of columns 4j + 2, 3
#pragma unroll
        for (int i = 0; i < NQ; ++i) {
          bf16* dst = qs + i * ROWS * y.qs + at;
          *reinterpret_cast<__nv_bfloat162*>(dst) =
              __halves2bfloat162(t[0][i], t[1][i]);
          *reinterpret_cast<__nv_bfloat162*>(dst + HI) =
              __halves2bfloat162(t[2][i], t[3][i]);
        }
      }
    }
    __syncthreads();
    load(0, k_lo);
  }
  tc::cp_async_commit();

  bool on[2];
  int pos[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int m = m0 + g + 8 * e;
    on[e] = m < live;
    pos[e] = st + m / h;
  }
  float o[4 * NV4][4];
#pragma unroll
  for (int n = 0; n < 4 * NV4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.f, 0.f};
  const int nks = y.lq / 16;               // k16 steps over L

  for (int it = 0; it < ntiles; ++it) {
    const int t0 = k_lo + it * KT, stg = it & 1;
    if (it + 1 < ntiles) {
      load(stg ^ 1, t0 + KT);              // the slot tile it-1 freed
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    const uint8_t* kt = raw + stg * KT * y.rs;
    const float* sct = sc + stg * KT;

    // This warp's share of S = Q K^T: k16 steps warp, warp + 4, ...
    float sa[NQ][NK][4];
#pragma unroll
    for (int i = 0; i < NQ; ++i)
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sa[i][n][e] = 0.f;
#pragma unroll 3
    for (int ks = warp; ks < nks; ks += NW) {
      uint32_t af[NQ][4];
#pragma unroll
      for (int i = 0; i < NQ; ++i)
        tc::ldmatrix_x4(af[i], qs + (i * ROWS + (lane & 15)) * y.qs +
                                   ks * 16 + (lane >> 4) * 8);
      if constexpr (P::CODES) {
        // Columns 4j..4j+3 of this step; those at or past L (the pool's
        // pad, only in the last step) are zeroed: never scored.
        const int col = ks * 16 + 4 * j4;
        const int keep = L - col;
        const uint32_t mask = keep >= 4   ? 0xffffffffu
                              : keep <= 0 ? 0u
                                          : (1u << (8 * keep)) - 1u;
#pragma unroll
        for (int n = 0; n < NK; ++n) {
          const uint32_t w = mask & *reinterpret_cast<const uint32_t*>(
                                        kt + (n * 8 + g) * y.rs + col);
          uint32_t b0, b1;
          P::Codec::quad_bf16(w, b0, b1);
#pragma unroll
          for (int i = 0; i < NQ; ++i) tc::mma_bf16(sa[i][n], af[i], b0, b1);
        }
      } else {
        // A thread's columns 2j, 2j+1 (b0) and 2j+8, 2j+9 (b1) of this
        // step; those at or past L (the row's pad, or what the ring held
        // before) are zeroed: never scored.
        const int col = ks * 16 + 2 * j4;
        const uint32_t m0 = pair_mask(L - col), m1 = pair_mask(L - col - 8);
#pragma unroll
        for (int n2 = 0; n2 < NK / 2; ++n2) {
          uint32_t kb[4];
          tc::ldmatrix_x4(
              kb, kt + (n2 * 16 + (lane & 7) + ((lane >> 4) << 3)) * y.rs +
                      (ks * 16 + ((lane >> 3) & 1) * 8) * 2);
#pragma unroll
          for (int i = 0; i < NQ; ++i) {
            tc::mma_bf16(sa[i][2 * n2], af[i], kb[0] & m0, kb[1] & m1);
            tc::mma_bf16(sa[i][2 * n2 + 1], af[i], kb[2] & m0, kb[3] & m1);
          }
        }
      }
    }
    float* xw = xs + warp * ROWS * XS;
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<float2*>(xw + (g + 8 * hf) * XS + n * 8 + 2 * j4) =
            make_float2((sa[0][n][2 * hf] + sa[1][n][2 * hf]) +
                            sa[2][n][2 * hf],
                        (sa[0][n][2 * hf + 1] + sa[1][n][2 * hf + 1]) +
                            sa[2][n][2 * hf + 1]);
    __syncthreads();

    // S (every warp sums the four shares in the same order), scaled
    // (CodePool: also by each key's scale), masked, then the online softmax
    // of rows g, g + 8.
    float s[NK][4];
    float mx[2] = {mrow[0], mrow[1]};
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kk = n * 8 + 2 * j4 + (e & 1), t = t0 + kk, rr = e >> 1;
        const int at = (g + 8 * rr) * XS + kk;
        float x = ((xs[at] + xs[ROWS * XS + at]) + xs[2 * ROWS * XS + at]) +
                  xs[3 * ROWS * XS + at];
        if constexpr (P::CODES)
          x *= sct[kk] * scale_log2;
        else
          x *= scale_log2;
        if (!on[rr] || t >= k_hi || t > pos[rr]) x = -INFINITY;
        s[n][e] = x;
        mx[rr] = fmaxf(mx[rr], x);
      }
    }
    float mu[2], alpha[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const float mn = tc::quad_max(mx[rr]);
      mu[rr] = mn == -INFINITY ? 0.f : mn;    // no live key yet: p = 0
      alpha[rr] = exp2f(mrow[rr] - mu[rr]);
      mrow[rr] = mn;
      lrow[rr] *= alpha[rr];
    }
#pragma unroll
    for (int n = 0; n < 4 * NV4; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[n][e] - mu[e >> 1]);
        lrow[e >> 1] += p;
        if constexpr (P::CODES)
          s[n][e] = p * sct[n * 8 + 2 * j4 + (e & 1)];   // p · s_t
        else
          s[n][e] = p;
      }
    }

    // O += P V (CodePool: P · s_t) over this warp's 32-column groups, P in
    // three bf16 terms.  CodePool: one ldmatrix.trans of the raw bytes (a
    // b16 unit = two columns) gives a thread keys 2j, 2j+1 (and 2j+8,
    // 2j+9) at columns 2g, 2g+1 of 16; byte permutes part them into the
    // even-column and the odd-column n8 tiles.  Bf16Pool: ldmatrix.trans
    // of the rows gives the n8 tiles of 16 columns.  A group past r reads
    // clamped columns and is never stored: no branch in the loop.
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      uint32_t p0[NP], p1[NP], p2[NP], p3[NP];
      tc::split_trunc<NP>(s[2 * kk][0], s[2 * kk][1], p0);
      tc::split_trunc<NP>(s[2 * kk][2], s[2 * kk][3], p1);
      tc::split_trunc<NP>(s[2 * kk + 1][0], s[2 * kk + 1][1], p2);
      tc::split_trunc<NP>(s[2 * kk + 1][2], s[2 * kk + 1][3], p3);
      const uint8_t* v0 =
          kt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * y.rs;
      if constexpr (!P::CODES) {
#pragma unroll
        for (int k4 = 0; k4 < NV4; ++k4) {
          const int grp = warp + NW * k4;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            uint32_t vb[4];
            tc::ldmatrix_x4_trans(
                vb, v0 + 2 * min(grp * 32 + hf * 16 + (lane >> 4) * 8,
                                 y.lq - 8));
#pragma unroll
            for (int i = 0; i < NP; ++i) {
              const uint32_t pa[4] = {p0[i], p1[i], p2[i], p3[i]};
              tc::mma_bf16(o[4 * k4 + 2 * hf], pa, vb[0], vb[1]);
              tc::mma_bf16(o[4 * k4 + 2 * hf + 1], pa, vb[2], vb[3]);
            }
          }
        }
      } else {
#pragma unroll
        for (int k4 = 0; k4 < NV4; ++k4) {
          const int grp = warp + NW * k4;
          uint32_t r4[4];
          tc::ldmatrix_x4_trans(
              r4, v0 + min(grp * 32 + (lane >> 4) * 16, y.lq - 16));
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
            for (int odd = 0; odd < 2; ++odd) {
              uint32_t b0, b1;
              P::Codec::quad_bf16(__byte_perm(r4[2 * hf], r4[2 * hf + 1],
                                              odd ? 0x7531 : 0x6420),
                                  b0, b1);
#pragma unroll
              for (int i = 0; i < NP; ++i) {
                const uint32_t pa[4] = {p0[i], p1[i], p2[i], p3[i]};
                tc::mma_bf16(o[4 * k4 + 2 * hf + odd], pa, b0, b1);
              }
            }
          }
        }
      }
    }
    __syncthreads();                       // the ring slot is free again
  }

  const float lsum[2] = {tc::quad_sum(lrow[0]), tc::quad_sum(lrow[1])};
  const int slot = tile * ns + split;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int m = m0 + g + 8 * e;
    if (m >= nrows) continue;
    float* dst;
    float mul;
    if (ns == 1) {
      dst = ctx + row_off(m, r);
      mul = on[e] && lsum[e] > 0.f ? 1.f / lsum[e] : 0.f;
    } else {
      const size_t prow =
          (static_cast<size_t>(b) * ymax + slot) * ROWS + g + 8 * e;
      dst = part_o + prow * r;
      mul = 1.f;
      if (warp == 0 && j4 == 0) {
        part_ml[2 * prow] = mrow[e];
        part_ml[2 * prow + 1] = lsum[e];
      }
    }
    if constexpr (!P::CODES) {
      // Group grp's n8 tile n: this thread's columns grp·32 + 8n + 2j, +1.
#pragma unroll
      for (int k4 = 0; k4 < NV4; ++k4) {
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int col = (warp + NW * k4) * 32 + 8 * n + 2 * j4;
          const float v0 = o[4 * k4 + n][2 * e] * mul;
          const float v1 = o[4 * k4 + n][2 * e + 1] * mul;
          if (col + 2 <= r && (r & 1) == 0) {
            *reinterpret_cast<float2*>(dst + col) = make_float2(v0, v1);
          } else {
            if (col < r) dst[col] = v0;
            if (col + 1 < r) dst[col + 1] = v1;
          }
        }
      }
    } else {
      // Group grp's half hf: this thread's columns base .. base + 3 are the
      // even tile's 2j, the odd tile's 2j, the even's 2j+1, the odd's 2j+1.
#pragma unroll
      for (int k4 = 0; k4 < NV4; ++k4) {
        const int grp = warp + NW * k4;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int base = grp * 32 + hf * 16 + 4 * j4;
          const float* ev = o[4 * k4 + 2 * hf];
          const float* od = o[4 * k4 + 2 * hf + 1];
          const float v4[4] = {ev[2 * e] * mul, od[2 * e] * mul,
                               ev[2 * e + 1] * mul, od[2 * e + 1] * mul};
          if (base + 4 <= r && (r & 3) == 0) {
            *reinterpret_cast<float4*>(dst + base) =
                make_float4(v4[0], v4[1], v4[2], v4[3]);
          } else {
#pragma unroll
            for (int x = 0; x < 4; ++x)
              if (base + x < r) dst[base + x] = v4[x];
          }
        }
      }
    }
  }
}

// ctx of the rows whose keys were split: grid (B, tiles, ROWS), one block
// a row of a live tile (span == nullptr: the decode form, span 1).
// The split weights 2^(m_i - M) go to shared memory first; each thread
// then sums its columns over the splits with the loads of eight splits in
// flight at a time.
__global__ void __launch_bounds__(NT)
    combine(float* __restrict__ ctx, const float* __restrict__ part_o,
            const float* __restrict__ part_ml, const int* __restrict__ span,
            const int* __restrict__ start, int h, int c, int r, int cap,
            int nsplit, int ymax, int min_len) {
  __shared__ float w_s[MAX_SPLITS];
  __shared__ float inv_s;
  const int b = blockIdx.x, tile = blockIdx.y, rr = blockIdx.z;
  const int sp = span == nullptr ? 1 : span[b];
  const int live = sp * h;
  const int tlive = (live + ROWS - 1) / ROWS;
  const int ns = row_splits(tlive, min(start[b] + sp, cap), nsplit, ymax,
                            min_len);
  const int m = tile * ROWS + rr;
  if (ns == 1 || tile >= tlive || m >= c * h) return;
  float* dst = ctx + ((static_cast<size_t>(b) * h + m % h) * c + m / h) * r;
  if (m >= live) {
    for (int col = threadIdx.x; col < r; col += NT) dst[col] = 0.f;
    return;
  }
  const size_t p0 = (static_cast<size_t>(b) * ymax + tile * ns) * ROWS + rr;
  if (threadIdx.x < 32) {
    const int s = threadIdx.x;
    float mi = -INFINITY, li = 0.f;
    for (int i = s; i < ns; i += 32) {     // ns <= MAX_SPLITS <= 32
      mi = part_ml[2 * (p0 + i * ROWS)];
      li = part_ml[2 * (p0 + i * ROWS) + 1];
    }
    const float mmax = rt::warp_max(mi);
    const float w = mi == -INFINITY ? 0.f : exp2f(mi - mmax);
    const float lsum = rt::warp_sum(w * li);
    if (s < ns) w_s[s] = w;
    if (s == 0) inv_s = lsum > 0.f ? 1.f / lsum : 0.f;
  }
  __syncthreads();
  const float inv = inv_s;
  // Each thread's columns tid + NT·k; the loads of 8 splits in flight.
  constexpr int CPT = MAX_R / NT;          // columns a thread at most
  const float* src = part_o + p0 * r;
  float acc[CPT] = {};
  for (int s0 = 0; s0 < ns; s0 += 8) {
    float v[8][CPT];
#pragma unroll
    for (int u = 0; u < 8; ++u)
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        const int col = threadIdx.x + NT * k;
        v[u][k] = s0 + u < ns && col < r
                      ? src[static_cast<size_t>(s0 + u) * ROWS * r + col]
                      : 0.f;
      }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const float wu = s0 + u < ns ? w_s[s0 + u] : 0.f;
#pragma unroll
      for (int k = 0; k < CPT; ++k) acc[k] += wu * v[u][k];
    }
  }
#pragma unroll
  for (int k = 0; k < CPT; ++k)
    if (threadIdx.x + NT * k < r) dst[threadIdx.x + NT * k] = acc[k] * inv;
}

// The walk (and, with several splits, the combine) over a pool of policy
// P, with q_rope of type QR; returns the CUDA status.
template <class P, typename QR>
int launch(const float* q_abs, const QR* q_rope, float* ctx,
           const void* pool, const float* scales, const int* bt,
           const int* start, const int* span, float* part, int b, int h,
           int c, int r, int L, int dp, int ps, int maxp, int nsplit,
           int min_len, float scale, cudaStream_t stream) {
  const Layout y = layout<P>(L);
  cudaError_t err = cudaFuncSetAttribute(
      walk<P, QR>, cudaFuncAttributeMaxDynamicSharedMemorySize, y.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (c * h + ROWS - 1) / ROWS;
  const int ymax = max(ROW_BLOCKS * tiles, nsplit);
  float* part_o = part;
  float* part_ml = part == nullptr
                       ? nullptr
                       : part + static_cast<size_t>(b) * ymax * ROWS * r;
  walk<P, QR><<<dim3(b, ymax), NT, y.bytes, stream>>>(
      q_abs, q_rope, ctx, static_cast<const uint8_t*>(pool), scales, bt,
      start, span, part_o, part_ml, h, c, r, L, dp, ps, maxp, nsplit,
      min_len, scale * LOG2E);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return static_cast<int>(err);
  combine<<<dim3(b, tiles, ROWS), NT, 0, stream>>>(
      ctx, part_o, part_ml, span, start, h, c, r, maxp * ps, nsplit, ymax,
      min_len);
  return static_cast<int>(cudaGetLastError());
}

// The four paged-MLA kernels on a pool of policy P: the fused write
// (mla_common.cuh; its own launch, so every row a query may read is
// resident before any block reads it), then the walk.  q_abs: float32
// [B, H, C, r]; q_rope: [B, H, C, rd] of qr_dtype (0 float32, 1 bf16);
// ctx: float32 [B, H, C, r]; lnew: IT [B, C, Dp] (a Bf16Pool's is bf16,
// a CodePool's float32 or bf16, quantized in the write).  start / span:
// i32[B]; span == nullptr is the decode form (c == 1, start = pos).
// scales: a CodePool's row scales (a Bf16Pool takes none).  part:
// B·ymax·ROWS·(r + 2) floats of scratch, ymax = max(ROW_BLOCKS·tiles,
// nsplit), when nsplit > 1 (O partials, then (m, l) pairs).  Returns the
// CUDA status.
template <class P, typename IT>
int run(const float* q_abs, const void* q_rope, int qr_dtype, float* ctx,
        void* pool, float* scales, const void* lnew, const int* bt,
        const int* start, const int* span, float* part, int b, int h, int c,
        int r, int rd, int dp, int ps, int maxp, int nsplit, int min_len,
        float scale, cudaStream_t stream) {
  if (r > MAX_R || nsplit < 1 || nsplit > MAX_SPLITS || min_len < 1 ||
      (nsplit > 1 && part == nullptr) || (span == nullptr && c != 1) ||
      (qr_dtype != 0 && qr_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (b == 0 || c == 0 || h == 0) return 0;
  int err;
  if constexpr (P::CODES) {
    mla::write_latent_quant<IT, typename P::Codec>
        <<<dim3(b, (c + mla::WARPS - 1) / mla::WARPS), mla::NT, 0, stream>>>(
            static_cast<typename P::Codec::S*>(pool), scales,
            static_cast<const IT*>(lnew), bt, start, span, c, dp, ps, maxp);
    err = static_cast<int>(cudaGetLastError());
  } else {
    err = mla::launch_write_latent(static_cast<IT*>(pool), lnew, bt, start,
                                   span, b, c, dp, ps, maxp, stream);
  }
  if (err) return err;
  if (qr_dtype == 0)
    return launch<P>(q_abs, static_cast<const float*>(q_rope), ctx, pool,
                     scales, bt, start, span, part, b, h, c, r, r + rd, dp,
                     ps, maxp, nsplit, min_len, scale, stream);
  return launch<P>(q_abs, static_cast<const bf16*>(q_rope), ctx, pool,
                   scales, bt, start, span, part, b, h, c, r, r + rd, dp, ps,
                   maxp, nsplit, min_len, scale, stream);
}

}  // namespace mla_mma
