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
// lane's (idx, key) read once; integer compares only.
//
// Design:
//   * Each block owns a tile of TILE rows.  It stages the lanes' (idx, key)
//     in shared memory, NT at a time; warp w scans the staged lanes w,
//     w + WARPS, ... and keeps, per row of the tile (one row per thread of
//     the warp), the best (key, lane) seen, starting from the bank's key
//     with no lane.  The WARPS candidates of a row are then reduced by
//     (larger key, then lower lane).  Each block reads every lane's
//     (idx, key): Dc x 8 bytes per block, from L2 after the first.
//   * Then the block writes its rows: a row whose best lane exists takes
//     that lane's payload row and key, every other row the bank's.  Each
//     output row is written once, as bytes (byte_rows.cuh), so every dtype
//     is bitwise.
//   * The Pallas kernel instead sweeps every lane over every 1024-row tile
//     with a where over the tile (K x Dc row compares and selects) and
//     pads K, D and Dc; nothing here is padded.
#include "byte_rows.cuh"

namespace {

constexpr int NT = 256;                // threads per block
constexpr int WARPS = NT / 32;
constexpr int TILE = 32;               // bank rows per block
static_assert(TILE == 32, "one row per lane of a warp");

// (k, l) beats (bk, bl): a larger key, or the same key from a lower lane.
// A row's starting candidate is (bank key, -1); a lane is only ever taken
// with a key strictly above the bank's, so a -1 never ties with a lane.
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
  __shared__ int s_idx[NT];
  __shared__ int s_key[NT];
  __shared__ int s_best_k[WARPS][TILE];
  __shared__ int s_best_l[WARPS][TILE];
  __shared__ int s_lane[TILE];

  const int row0 = blockIdx.x * TILE;
  const int warp = threadIdx.x / 32;
  const int r = threadIdx.x % 32;          // this thread's row of the tile
  const int row = row0 + r;
  int best_k = row < k ? key[row] : 0;
  int best_l = -1;
  for (int base = 0; base < dc; base += NT) {
    const int j = base + threadIdx.x;
    s_idx[threadIdx.x] = j < dc ? d_idx[j] : -1;
    s_key[threadIdx.x] = j < dc ? d_key[j] : 0;
    __syncthreads();
    const int n = dc - base < NT ? dc - base : NT;
    for (int t = warp; t < n; t += WARPS) {
      // Lanes out of [0, K) never equal a row < K.
      if (s_idx[t] == row && row < k && beats(s_key[t], base + t, best_k,
                                              best_l)) {
        best_k = s_key[t];
        best_l = base + t;
      }
    }
    __syncthreads();
  }
  s_best_k[warp][r] = best_k;
  s_best_l[warp][r] = best_l;
  __syncthreads();
  if (warp == 0) {
    for (int w = 1; w < WARPS; ++w)
      if (beats(s_best_k[w][r], s_best_l[w][r], best_k, best_l)) {
        best_k = s_best_k[w][r];
        best_l = s_best_l[w][r];
      }
    s_lane[r] = best_l;
    if (row < k) key_o[row] = best_k;
  }
  __syncthreads();

  const int rows = k - row0 < TILE ? k - row0 : TILE;
  const long long per_row = row_bytes / static_cast<long long>(sizeof(V));
  for (long long i = threadIdx.x; i < rows * per_row; i += NT) {
    const int rr = static_cast<int>(i / per_row);
    const long long c = i - rr * per_row;
    const int lane = s_lane[rr];
    const char* src = lane >= 0 ? d_pay + lane * row_bytes
                                : pay + (row0 + rr) * row_bytes;
    copy_access<V>(src, pay_o + (row0 + rr) * row_bytes, c);
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
