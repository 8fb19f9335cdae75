// Cross-pool page-row transfer: lane i copies src_pool[src_ids[i]] into
// dst_pool[dst_ids[i]], the physical move of disaggregated adoption
// (models/cache.copy_pages_across, once per pool leaf per paged layer).
// Replaces the TPU kernel src/repro/kernels/page_transfer.py ·
// page_transfer (pl.pallas_call at :96).  A -1 on either side drops the
// lane, and so does a dst_id past the destination pool; a src_id past the
// source pool reads its last row (the oracle's clip).
//
// Bound on the H100: bytes.  Each live lane reads one row and writes one
// row; there is no arithmetic.  The rows are treated as bytes, so the copy
// is bitwise for every pool dtype (bf16, int8, fp8, the f32 scale rows).
//
// Design:
//   * Grid (lanes, slices of a row): each block moves one SLICE-byte slice
//     of one lane's row.  The TPU kernel stages a whole row per grid step;
//     here one block per lane would leave a one-lane transfer (what an
//     adoption issues per page) on one SM, and an OLMo-1B row is 64 KB a
//     leaf, so the row is spread over 8 blocks.
//   * Rows are copied as bytes (byte_rows.cuh): 16-byte vector loads and
//     stores where the row's byte size and both pool base pointers are
//     16-byte aligned (then every row and every slice is); 4-byte words
//     where they are 4-byte aligned; single bytes otherwise (an int8 row of
//     odd width).  The width is chosen once per launch; every path is this
//     kernel, never the plain version.
//   * Duplicate destinations: the Pallas kernel's grid is sequential, so
//     where live lanes share a dst_id the last one wins.  Here blocks run
//     in any order, so a lane skips itself if any later live lane targets
//     the same row.  The block's threads scan the later lanes' ids
//     together (O(N) per block, O(N^2) per launch); N is the pages of one
//     transfer (1 per adoption, a few dozen at most), so the scan costs
//     less than the row it decides about.
//   * No TMA and no cp.async.bulk: plain vector loads already stream one
//     row per block set; a bulk-copy design is later, measured work.
#include "byte_rows.cuh"

namespace {

constexpr int NT = 256;          // threads per block
constexpr long long SLICE = 8192;  // bytes of a row one block moves

template <typename V>
__device__ __forceinline__ void copy_slice(const char* __restrict__ src,
                                           char* __restrict__ dst,
                                           long long lo, long long hi) {
  const long long n = (hi - lo) / static_cast<long long>(sizeof(V));
  for (long long i = threadIdx.x; i < n; i += NT)
    copy_access<V>(src + lo, dst + lo, i);
}

template <typename V>
__global__ void __launch_bounds__(NT)
    transfer(const char* __restrict__ src, char* __restrict__ dst,
             const int* __restrict__ src_ids, const int* __restrict__ dst_ids,
             int n, long long num_src, long long num_dst,
             long long row_bytes) {
  const int lane = blockIdx.x;
  const int s = src_ids[lane];
  const int d = dst_ids[lane];
  if (s < 0 || d < 0 || d >= num_dst) return;
  // Superseded by a later live lane with the same destination?  The later
  // lane's dst_id equals d, so it is in range; it is live iff its src_id
  // is not -1.
  int later = 0;
  for (int j = lane + 1 + threadIdx.x; j < n; j += NT)
    later |= (dst_ids[j] == d) & (src_ids[j] >= 0);
  if (__syncthreads_or(later)) return;
  const long long row_s = s < num_src ? s : num_src - 1;
  const long long lo = static_cast<long long>(blockIdx.y) * SLICE;
  const long long hi = lo + SLICE < row_bytes ? lo + SLICE : row_bytes;
  const char* srow = src + row_s * row_bytes;
  char* drow = dst + static_cast<long long>(d) * row_bytes;
  copy_slice<V>(srow, drow, lo, hi);
}

}  // namespace

extern "C" const char* rt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// src, dst: the two pools' base pointers (row-major [P, row_bytes] bytes,
// distinct allocations); src_ids, dst_ids: int32[n] on the device.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int page_transfer(const void* src, void* dst, const void* src_ids,
                             const void* dst_ids, int n, long long num_src,
                             long long num_dst, long long row_bytes,
                             void* stream) {
  if (n <= 0 || row_bytes <= 0 || num_src <= 0) return 0;
  const uintptr_t bits = reinterpret_cast<uintptr_t>(src) |
                         reinterpret_cast<uintptr_t>(dst) |
                         static_cast<uintptr_t>(row_bytes);
  const dim3 grid(n, static_cast<unsigned>((row_bytes + SLICE - 1) / SLICE));
  return static_cast<int>(dispatch_width(bits, [&](auto v) {
    transfer<decltype(v)><<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const char*>(src), static_cast<char*>(dst),
        static_cast<const int*>(src_ids), static_cast<const int*>(dst_ids), n,
        num_src, num_dst, row_bytes);
    return cudaGetLastError();
  }));
}
