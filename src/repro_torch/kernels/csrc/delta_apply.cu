// LWW-guarded scatter of a delta buffer into a register bank: lane j
// writes register d_idx[j] (key d_key[j], payload row d_pay[j]) where its
// key is strictly greater than the bank's.  The result is a new bank.
// Replaces the TPU kernel src/repro/kernels/delta_apply.py · delta_apply
// (pl.pallas_call at :72).  A d_idx outside [0, K) is an empty lane.
//
// Duplicate targets: the Pallas kernel sweeps the lanes in order with a
// strict >, so for each register the lane with the largest key wins (if
// that key beats the bank's), and among lanes with that same key the
// lowest lane index.  Here lanes are compared in parallel, so that rule is
// built into the reduction that picks each row's lane; the result does not
// depend on the order threads or blocks run in.  No atomics and no scratch
// memory: nothing is shared between blocks.
//
// Bound on the H100: bytes.  Each register's key and one source row (the
// bank's or the winning lane's) read once and written once, and every
// lane's (idx, key) read once; integer compares only.  At bench_merge's
// bank (K 4096, int32 rows of 512 B, Dc 256): 4.2 MB, 1.26 µs.
//
// What held the first kernel back: 32-row tiles gave 128 blocks (one an
// SM), and each block scanned the lanes before it touched the 16 KB of
// bank rows that are 97 % of its bytes, then copied them in a loop of
// 16-byte load->store pairs: a few KB in flight an SM, HBM latency paid
// after a latency-bound scan.  The design:
//   * 16-row tiles: 256 blocks at K 4096, two an SM, all resident at once.
//   * The bank rows first.  Each thread issues its loads of the tile's
//     bytes (up to HELD accesses of the widest width the rows allow, 8 KB
//     a block at 512-byte rows) into registers before anything else, so
//     HBM latency overlaps the key reads, the lane staging and the
//     reduction.  A tile wider than NT x HELD accesses copies the rest
//     after the scan.
//   * The scan, with no shared-memory staging and no per-row sweep:
//     thread t takes lanes t, t + NT, ...; a lane that targets a row of
//     the tile (rare: about Dc x TILE / K a tile) shows in its warp's
//     ballot, and the warp thread that owns that row folds it into its
//     best (key, lane).  The WARPS candidates of a row and the bank's key
//     are then reduced by (larger key, then lower lane).  Each block
//     reads every lane's (idx, key): Dc x 8 bytes a block, from L2 after
//     the first.
//   * Each output row is written once, as bytes (byte_rows.cuh), so every
//     dtype is bitwise: a row whose best lane exists takes that lane's
//     payload row (L2-resident after the first block) and key, every other
//     row the bank's, from the registers.
//   * The Pallas kernel instead sweeps every lane over every 1024-row tile
//     with a where over the tile (K x Dc row compares and selects) and
//     pads K, D and Dc; nothing here is padded.
#include "byte_rows.cuh"

namespace {

constexpr int NT = 256;                // threads per block
constexpr int WARPS = NT / 32;
constexpr int TILE = 16;               // bank rows per block
constexpr int HELD = 4;                // bank accesses a thread holds
constexpr unsigned FULL = 0xffffffffu;
static_assert(TILE <= 32, "a warp thread owns each row of the tile");

// (k, l) beats (bk, bl): a larger key, or the same key from a lower lane.
// A row starts from the bank's key with no lane (-1), a warp's candidate
// from (INT32_MIN, -1); a lane is only ever taken with a key strictly
// above the candidate's, so a -1 never ties with a lane.
__device__ __forceinline__ bool beats(int k, int l, int bk, int bl) {
  return k > bk || (k == bk && l >= 0 && bl >= 0 && l < bl);
}

template <typename V>
__global__ void __launch_bounds__(NT)
    delta_apply_rows(const int* __restrict__ key,
                     const char* __restrict__ pay,
                     const int* __restrict__ d_idx,
                     const int* __restrict__ d_key,
                     const char* __restrict__ d_pay, int* __restrict__ key_o,
                     char* __restrict__ pay_o, int k, int dc,
                     long long row_bytes) {
  __shared__ int s_best_k[WARPS][TILE];
  __shared__ int s_best_l[WARPS][TILE];
  __shared__ int s_lane[TILE];

  const int row0 = blockIdx.x * TILE;
  const int rows = k - row0 < TILE ? k - row0 : TILE;
  const long long per_row = row_bytes / static_cast<long long>(sizeof(V));
  const long long n_acc = rows * per_row;   // the tile's accesses
  const V* bank = reinterpret_cast<const V*>(pay + row0 * row_bytes);
  V* out = reinterpret_cast<V*>(pay_o + row0 * row_bytes);

  // 1. The tile's bank rows into registers, every load issued now, and
  // the tile's bank keys.
  V held[HELD];
#pragma unroll
  for (int u = 0; u < HELD; ++u) {
    const long long i = threadIdx.x + u * NT;
    if (i < n_acc) held[u] = bank[i];
  }
  const int bank_k = threadIdx.x < rows ? key[row0 + threadIdx.x] : 0;

  // 2. The lane scan, while those loads are in flight.  Warp thread r
  // keeps its warp's best lane for row r of the tile.
  const int warp = threadIdx.x / 32;
  const int wl = threadIdx.x % 32;
  int best_k = INT32_MIN;
  int best_l = -1;
  for (int base = 0; base < dc; base += NT) {
    const int j = base + threadIdx.x;
    const int idx = j < dc ? d_idx[j] : -1;
    const int kj = j < dc ? d_key[j] : 0;
    // Rows of the tile only: lanes out of [0, K) never fall in one.
    const unsigned r = static_cast<unsigned>(idx) -
                       static_cast<unsigned>(row0);
    const bool hit = j < dc && r < static_cast<unsigned>(rows);
    for (unsigned m = __ballot_sync(FULL, hit); m; m &= m - 1) {
      const int src = __ffs(m) - 1;
      const int hr = __shfl_sync(FULL, static_cast<int>(r), src);
      const int hk = __shfl_sync(FULL, kj, src);
      const int hl = base + warp * 32 + src;
      if (wl == hr && beats(hk, hl, best_k, best_l)) {
        best_k = hk;
        best_l = hl;
      }
    }
  }
  if (wl < TILE) {
    s_best_k[warp][wl] = best_k;
    s_best_l[warp][wl] = best_l;
  }
  __syncthreads();
  if (threadIdx.x < rows) {
    const int rr = threadIdx.x;
    int bk = bank_k;
    int bl = -1;
#pragma unroll
    for (int w = 0; w < WARPS; ++w)
      if (beats(s_best_k[w][rr], s_best_l[w][rr], bk, bl)) {
        bk = s_best_k[w][rr];
        bl = s_best_l[w][rr];
      }
    s_lane[rr] = bl;
    key_o[row0 + rr] = bk;
  }
  __syncthreads();

  // 3. Each output row once: the winning lane's row, else the bank's.
#pragma unroll
  for (int u = 0; u < HELD; ++u) {
    const long long i = threadIdx.x + u * NT;
    if (i < n_acc) {
      const int rr = static_cast<int>(i / per_row);
      const int lane = s_lane[rr];
      out[i] = lane >= 0 ? reinterpret_cast<const V*>(
                               d_pay + lane * row_bytes)[i - rr * per_row]
                         : held[u];
    }
  }
  for (long long i = threadIdx.x + HELD * NT; i < n_acc; i += NT) {
    const int rr = static_cast<int>(i / per_row);
    const int lane = s_lane[rr];
    const char* src = lane >= 0 ? d_pay + lane * row_bytes
                                : pay + (row0 + rr) * row_bytes;
    copy_access<V>(src, pay_o + (row0 + rr) * row_bytes, i - rr * per_row);
  }
}

template <typename V>
cudaError_t launch(const void* key, const void* pay, const void* d_idx,
                   const void* d_key, const void* d_pay, void* key_o,
                   void* pay_o, int k, int dc, long long row_bytes,
                   cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((k + TILE - 1) / TILE);
  delta_apply_rows<V><<<blocks, NT, 0, stream>>>(
      static_cast<const int*>(key), static_cast<const char*>(pay),
      static_cast<const int*>(d_idx), static_cast<const int*>(d_key),
      static_cast<const char*>(d_pay), static_cast<int*>(key_o),
      static_cast<char*>(pay_o), k, dc, row_bytes);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* rt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// key, key_o: int32[k]; pay, pay_o: k rows of row_bytes bytes; d_idx,
// d_key: int32[dc]; d_pay: dc rows of row_bytes bytes in pay's dtype; all
// row-major on the device, outputs distinct from inputs.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int delta_apply(const void* key, const void* pay,
                           const void* d_idx, const void* d_key,
                           const void* d_pay, void* key_o, void* pay_o,
                           int k, int dc, long long row_bytes,
                           void* stream) {
  if (k <= 0) return 0;
  const uintptr_t bits = reinterpret_cast<uintptr_t>(pay) |
                         reinterpret_cast<uintptr_t>(d_pay) |
                         reinterpret_cast<uintptr_t>(pay_o) |
                         static_cast<uintptr_t>(row_bytes);
  return static_cast<int>(dispatch_width(bits, [&](auto v) {
    return launch<decltype(v)>(key, pay, d_idx, d_key, d_pay, key_o, pay_o,
                               k, dc, row_bytes,
                               static_cast<cudaStream_t>(stream));
  }));
}
