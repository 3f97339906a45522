// Bit unpacking of RLE / bit-packed hybrid index streams, shared by the
// two hybrid expansions (expand_hybrid.cu, expand_page_grid.cu): a thread's
// N consecutive outputs of one bit-packed run of compile-time width W.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {
namespace hybrid {

template <int W>
__device__ __forceinline__ uint32_t low_bits(uint32_t v) {
  if constexpr (W >= 32) return v;
  else return v & ((1u << W) - 1u);
}

// N outputs of one bit-packed run from bit `pos0` of the words on: the words
// they span are loaded once (none past the last word the plain versions
// read, the one after the last output's first word) and shifted to pos0, so
// output k sits at the constant bit k * W.
template <int W, int N>
__device__ __forceinline__ void unpack_run(const uint32_t* words, unsigned pos0,
                                           uint32_t (&v)[N]) {
  constexpr int kAligned = ((N - 1) * W >> 5) + 2;
  const unsigned q0 = pos0 >> 5, sh = pos0 & 31;
  const unsigned q_last = ((pos0 + (N - 1) * W) >> 5) + 1;
  uint32_t w[kAligned + 1];
#pragma unroll
  for (int m = 0; m <= kAligned; ++m) w[m] = q0 + m <= q_last ? __ldg(words + q0 + m) : 0u;
  uint32_t a[kAligned];
#pragma unroll
  for (int m = 0; m < kAligned; ++m) a[m] = __funnelshift_r(w[m], w[m + 1], sh);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int bit = k * W;
    v[k] = low_bits<W>(__funnelshift_r(a[bit >> 5], a[(bit >> 5) + 1], bit & 31));
  }
}

}  // namespace hybrid
}  // namespace
