// LWW join of two register banks: for each register the larger packed
// (clock, client) key wins and its payload row comes with it; on equal
// keys bank a wins.  Replaces the TPU kernel
// src/repro/kernels/lww_merge.py · lww_merge (pl.pallas_call at :40).
//
// Bound on the H100: bytes.  Per register: two keys read, one written, the
// winner's payload row read once and written once; one integer compare.
//
// Design:
//   * The Pallas kernel computes jnp.where over 1024-row VMEM tiles, so it
//     reads both payload rows and pads K to 1024 and D to 128 lanes.  Here
//     nothing is padded, and each register copies only its winner's row:
//     the loser's row is never read.
//   * Payload rows are copied as bytes (byte_rows.cuh), so every dtype
//     (int32, float32, bf16, int8) is bitwise by construction; the access
//     width follows the row size and the three payload base pointers.
//   * One thread per (register, access) of the payload, flattened, in a
//     grid-stride loop: neighbouring threads move neighbouring 16-byte
//     words of a row.  The thread at a row's first access also writes the
//     row's key.  A row of zero bytes still takes one item, for its key.
#include "byte_rows.cuh"

namespace {

constexpr int NT = 256;          // threads per block
constexpr int MAX_BLOCKS = 132 * 16;

template <typename V>
__global__ void __launch_bounds__(NT)
    lww_merge_rows(const int* __restrict__ key_a,
                   const char* __restrict__ pay_a,
                   const int* __restrict__ key_b,
                   const char* __restrict__ pay_b, int* __restrict__ key_o,
                   char* __restrict__ pay_o, long long k,
                   long long row_bytes) {
  const long long per_row = row_bytes / static_cast<long long>(sizeof(V));
  const long long items_per_row = per_row > 0 ? per_row : 1;
  const long long total = k * items_per_row;
  for (long long i = blockIdx.x * static_cast<long long>(NT) + threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * NT) {
    const long long row = i / items_per_row;
    const long long c = i - row * items_per_row;
    const int ka = key_a[row];
    const int kb = key_b[row];
    const bool b_wins = kb > ka;
    if (c == 0) key_o[row] = b_wins ? kb : ka;
    if (c < per_row)
      copy_access<V>((b_wins ? pay_b : pay_a) + row * row_bytes,
                     pay_o + row * row_bytes, c);
  }
}

template <typename V>
cudaError_t launch(const void* key_a, const void* pay_a, const void* key_b,
                   const void* pay_b, void* key_o, void* pay_o, long long k,
                   long long row_bytes, cudaStream_t stream) {
  const long long per_row = row_bytes / static_cast<long long>(sizeof(V));
  const long long total = k * (per_row > 0 ? per_row : 1);
  long long blocks = (total + NT - 1) / NT;
  if (blocks > MAX_BLOCKS) blocks = MAX_BLOCKS;
  lww_merge_rows<V><<<static_cast<unsigned>(blocks), NT, 0, stream>>>(
      static_cast<const int*>(key_a), static_cast<const char*>(pay_a),
      static_cast<const int*>(key_b), static_cast<const char*>(pay_b),
      static_cast<int*>(key_o), static_cast<char*>(pay_o), k, row_bytes);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* rt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// key_a, key_b, key_o: int32[k]; pay_a, pay_b, pay_o: k rows of row_bytes
// bytes each, row-major, on the device.  Returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int lww_merge(const void* key_a, const void* pay_a,
                         const void* key_b, const void* pay_b, void* key_o,
                         void* pay_o, long long k, long long row_bytes,
                         void* stream) {
  if (k <= 0) return 0;
  const uintptr_t bits = reinterpret_cast<uintptr_t>(pay_a) |
                         reinterpret_cast<uintptr_t>(pay_b) |
                         reinterpret_cast<uintptr_t>(pay_o) |
                         static_cast<uintptr_t>(row_bytes);
  return static_cast<int>(dispatch_width(bits, [&](auto v) {
    return launch<decltype(v)>(key_a, pay_a, key_b, pay_b, key_o, pay_o, k,
                               row_bytes, static_cast<cudaStream_t>(stream));
  }));
}
