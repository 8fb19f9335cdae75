// Diagonal linear recurrence h_t = a_t ⊙ h_{t-1} + b_t over time: the
// RG-LRU scan of every recurrent layer, in prefill and in every mixed step.
// Replaces the TPU kernel src/repro/kernels/rglru_scan.py · linear_scan
// (pl.pallas_call at :67): a, b [B, T, D], h0 [B, D]; returns y [B, T, D]
// in b's dtype and the float32 carry h_T [B, D].
//
// Bound on the H100: bytes.  a and b are read once and y written once
// (plus h0 and h_T), at one FMA per element.
//
// Design: one thread per (row, channel), walking time in order with
// h = __fmaf_rn(a, h, b): one rounding per step, as the plain version
// (kernels/ref.py) and JAX's CPU oracle round, so the result is equal bit
// for bit.  The TPU kernel's associative scan within a time block is a
// schedule for a vector unit with no threads to spare; here B·D threads
// (20,480 at the serving shapes) already fill the card, and the time loop
// is their only serial part.  Neighbouring threads take neighbouring
// channels, so each load of a warp is one coalesced 128-byte line.  The
// loads of a and b do not depend on h: each thread issues UNROLL steps'
// loads before the dependent FMA chain consumes them.  Time is not padded
// to a block multiple (the TPU wrapper's identity steps): the walk stops
// at T.
#include "attention_common.cuh"

namespace {

constexpr int NT = 128;     // threads (channels) per block
constexpr int UNROLL = 16;  // time steps whose loads are in flight at once

template <typename T>
__global__ void __launch_bounds__(NT)
    scan(const float* __restrict__ a, const T* __restrict__ b,
         const float* __restrict__ h0, T* __restrict__ y,
         float* __restrict__ h_t, int t_len, int d) {
  const int c = blockIdx.x * NT + threadIdx.x;
  const int row = blockIdx.y;
  if (c >= d) return;
  const size_t base = static_cast<size_t>(row) * t_len * d + c;
  float h = h0[static_cast<size_t>(row) * d + c];
  int t = 0;
  for (; t + UNROLL <= t_len; t += UNROLL) {
    float av[UNROLL], bv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const size_t o = base + static_cast<size_t>(t + u) * d;
      av[u] = a[o];
      bv[u] = rt::to_f(b[o]);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      h = __fmaf_rn(av[u], h, bv[u]);
      y[base + static_cast<size_t>(t + u) * d] = rt::from_f<T>(h);
    }
  }
  for (; t < t_len; ++t) {
    const size_t o = base + static_cast<size_t>(t) * d;
    h = __fmaf_rn(a[o], h, rt::to_f(b[o]));
    y[o] = rt::from_f<T>(h);
  }
  h_t[static_cast<size_t>(row) * d + c] = h;
}

template <typename T>
int launch(const void* a, const void* b, const void* h0, void* y, void* h_t,
           int batch, int t_len, int d, cudaStream_t stream) {
  if (batch == 0 || d == 0) return 0;
  const dim3 grid((d + NT - 1) / NT, batch);
  scan<T><<<grid, NT, 0, stream>>>(
      static_cast<const float*>(a), static_cast<const T*>(b),
      static_cast<const float*>(h0), static_cast<T*>(y),
      static_cast<float*>(h_t), t_len, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype (of b and y): 0 = float32, 1 = bfloat16; a, h0 and h_t are
// float32.  Returns cudaGetLastError() after the launch (0 on success),
// cudaErrorInvalidValue for an unsupported dtype.
extern "C" int linear_scan(int dtype, const void* a, const void* b,
                           const void* h0, void* y, void* h_t, int batch,
                           int t_len, int d, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(a, b, h0, y, h_t, batch, t_len, d, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(a, b, h0, y, h_t, batch, t_len, d, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
