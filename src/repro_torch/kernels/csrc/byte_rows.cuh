// Rows moved as raw bytes, for the kernels that copy rows whatever their
// dtype (page_transfer, lww_merge, delta_apply): the copy is bitwise by
// construction.  The access width is 16, 4 or 1 byte: the widest that the
// row's byte size and every base pointer the kernel moves rows through are
// aligned to (then every row, and every access in it, is), chosen once per
// launch on the host.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

// Calls f(V()) with V the access type (uint4, uint32_t or uint8_t) that
// `bits`, the OR of the base pointers and the row size, is aligned to, and
// returns what f returns.  f is a generic lambda that launches the kernel
// instantiated for V.
template <typename F>
auto dispatch_width(uintptr_t bits, F&& f) {
  if (bits % 16 == 0) return f(uint4());
  if (bits % 4 == 0) return f(uint32_t());
  return f(uint8_t());
}

// Access c (sizeof(V) bytes) of a row, from src to dst.
template <typename V>
__device__ __forceinline__ void copy_access(const char* __restrict__ src,
                                            char* __restrict__ dst,
                                            long long c) {
  reinterpret_cast<V*>(dst)[c] = reinterpret_cast<const V*>(src)[c];
}
