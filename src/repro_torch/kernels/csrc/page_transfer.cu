// Cross-pool page-row transfer over a table of pool pairs ("leaves"): for
// each leaf, lane i copies src_pool[src_ids[i]] into dst_pool[dst_ids[i]],
// the physical move of disaggregated adoption (models/cache
// .copy_pages_across and .adopt_pages: every pool leaf of every paged
// layer, K, V and the scale leaves, in one launch).  Replaces the TPU
// kernel src/repro/kernels/page_transfer.py · page_transfer (pl.pallas_call
// at :96), which moves one pool per call.  Per leaf: a -1 on either side
// drops the lane, and so does a dst_id past that leaf's destination pool;
// a src_id past the source pool reads its last row (the oracle's clip).
//
// Bound on the H100: bytes.  Each live lane reads one row and writes one
// row of every leaf; there is no arithmetic.  The rows are treated as
// bytes, so the copy is bitwise for every pool dtype (bf16, int8, fp8, the
// f32 scale rows).  A pulled OLMo-1B page is 32 leaves of 64 KB (bf16):
// 2 MB read and 2 MB written, 1.25 µs at 3.35 TB/s.
//
// What held the one-leaf kernel back: a pull issued one launch per leaf,
// 32 (bf16) or 64 (int8 / fp8, scales included) a page, each at the card's
// launch floor (~1.7 µs for 64 KB), and each 64 KB row ran on 8 blocks of
// 8 KB, a few KB in flight an SM.  The design:
//   * One launch, a table of leaves.  The table (base pointers, row bytes,
//     pool sizes, access width; the entry point adds the slices a row) is
//     a __grid_constant__ parameter, read from the parameter bank: no
//     device buffer and no host-to-device copy a call.  MAX_LEAVES
//     descriptors keep the parameters under 4 KB; the wrapper sends a
//     longer table in several launches.
//   * Grid (lanes x slices, leaves).  A block moves one slice of one
//     lane's row of one leaf: NT threads x U accesses, every load of a
//     thread issued before its stores.  U is 2: 8 KB a block at 16-byte
//     accesses, measured against U 1, 4 and 8 (4, 16, 32 KB) on an H100
//     (benchmarks/bench_transfer.py --slices, which builds patched copies
//     of this file; PERF.md).  A one-lane pull of OLMo's 32 leaves runs on
//     256 blocks, all resident at once on the 132 SMs, so the whole page
//     is in flight.  A leaf with fewer slices than the widest leaf leaves
//     its spare blocks empty.
//   * Access width per leaf (16, 4 or 1 byte), chosen by the wrapper from
//     the two base pointers' and the row's alignment (then every row and
//     every access in it is aligned); the launch checks it.
//   * Duplicate destinations: the Pallas kernel's grid is sequential, so
//     where live lanes share a dst_id the last one wins.  Here blocks run
//     in any order, so a lane skips itself if any later live lane targets
//     the same row of the same leaf.  The block's loads are issued first;
//     its threads then scan the later lanes' ids together (O(N) a block;
//     N is the pages of one transfer, 1 a pull) while the loads are in
//     flight, and only a lane no later lane supersedes stores.
//   * No TMA and no cp.async.bulk: plain vector loads keep the page in
//     flight already.
#include "byte_rows.cuh"

namespace {

constexpr int NT = 256;            // threads per block
constexpr int U = 2;               // accesses a thread (a slice: NT * U)
constexpr int MAX_LEAVES = 64;     // descriptors a launch

// One leaf.  The host packs every field but `slices` (ctypes in
// kernels/page_transfer.py, 48 bytes with `slices` as padding); the entry
// point sets it.
struct Leaf {
  const char* src;
  char* dst;
  long long row_bytes;
  long long num_src;
  long long num_dst;
  int width;       // bytes an access: 16, 4 or 1
  int slices;      // blocks a row: ceil(row_bytes / (NT * U * width))
};
static_assert(sizeof(Leaf) == 48, "the wrapper packs 48-byte descriptors");

struct Table {
  Leaf leaf[MAX_LEAVES];
};
static_assert(sizeof(Table) + 64 <= 4096, "parameters stay under 4 KB");

// Slice `slice` of one lane's row: thread t loads accesses t, t + NT, ...
// of the slice (U of them) into registers, then stores them unless a later
// live lane of the same destination supersedes this one.
template <typename V>
__device__ __forceinline__ void move_slice(const char* __restrict__ src,
                                           char* __restrict__ dst,
                                           long long row_bytes, int slice,
                                           const int* __restrict__ dst_ids,
                                           const int* __restrict__ src_ids,
                                           int lane, int n, int d) {
  const long long per_row = row_bytes / static_cast<long long>(sizeof(V));
  const long long lo = static_cast<long long>(slice) * NT * U;
  const V* s = reinterpret_cast<const V*>(src);
  V held[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long i = lo + threadIdx.x + u * NT;
    if (i < per_row) held[u] = s[i];
  }
  // Superseded by a later live lane with the same destination?  That
  // lane's dst_id equals d, so it is in range; it is live iff its src_id
  // is not -1.
  int later = 0;
  for (int j = lane + 1 + threadIdx.x; j < n; j += NT)
    later |= (dst_ids[j] == d) & (src_ids[j] >= 0);
  if (__syncthreads_or(later)) return;
  V* o = reinterpret_cast<V*>(dst);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long i = lo + threadIdx.x + u * NT;
    if (i < per_row) o[i] = held[u];
  }
}

__global__ void __launch_bounds__(NT)
    transfer(const __grid_constant__ Table table,
             const int* __restrict__ src_ids,
             const int* __restrict__ dst_ids, int n, int slices) {
  const Leaf& L = table.leaf[blockIdx.y];
  const int lane = blockIdx.x / slices;
  const int slice = blockIdx.x - lane * slices;
  if (slice >= L.slices) return;
  const int s = src_ids[lane];
  const int d = dst_ids[lane];
  if (s < 0 || d < 0 || d >= L.num_dst) return;
  const long long row_s = s < L.num_src ? s : L.num_src - 1;
  const char* src = L.src + row_s * L.row_bytes;
  char* dst = L.dst + static_cast<long long>(d) * L.row_bytes;
  if (L.width == 16)
    move_slice<uint4>(src, dst, L.row_bytes, slice, dst_ids, src_ids, lane,
                      n, d);
  else if (L.width == 4)
    move_slice<uint32_t>(src, dst, L.row_bytes, slice, dst_ids, src_ids,
                         lane, n, d);
  else
    move_slice<uint8_t>(src, dst, L.row_bytes, slice, dst_ids, src_ids,
                        lane, n, d);
}

}  // namespace

extern "C" const char* rt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// leaves: n_leaves (1..MAX_LEAVES) host descriptors, each pool pair
// row-major [P, row_bytes] bytes on the device, every destination distinct
// from every other pool of the table; src_ids, dst_ids: int32[n] on the
// device.  Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a table the kernel cannot take.
extern "C" int page_transfer(const void* leaves, int n_leaves,
                             const void* src_ids, const void* dst_ids, int n,
                             void* stream) {
  if (n_leaves < 1 || n_leaves > MAX_LEAVES || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Table table{};
  int slices = 0;
  for (int i = 0; i < n_leaves; ++i) {
    Leaf L = static_cast<const Leaf*>(leaves)[i];
    const uintptr_t bits = reinterpret_cast<uintptr_t>(L.src) |
                           reinterpret_cast<uintptr_t>(L.dst) |
                           static_cast<uintptr_t>(L.row_bytes);
    if ((L.width != 16 && L.width != 4 && L.width != 1) || bits % L.width ||
        L.row_bytes <= 0 || L.num_src <= 0 || L.num_dst < 0)
      return static_cast<int>(cudaErrorInvalidValue);
    const long long slice_bytes = static_cast<long long>(NT) * U * L.width;
    const long long row_slices = (L.row_bytes + slice_bytes - 1) / slice_bytes;
    if (row_slices > 0x7fffffffLL)
      return static_cast<int>(cudaErrorInvalidValue);
    L.slices = static_cast<int>(row_slices);
    table.leaf[i] = L;
    slices = L.slices > slices ? L.slices : slices;
  }
  if (n == 0) return 0;
  if (static_cast<long long>(n) * slices > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(n) * slices, n_leaves);
  transfer<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      table, static_cast<const int*>(src_ids),
      static_cast<const int*>(dst_ids), n, slices);
  return static_cast<int>(cudaGetLastError());
}
