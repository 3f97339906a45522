// Word assembly of the LSB-first bit-pack, shared by bitpack_encode.cu and
// rle_hybrid_encode.cu: value i at bits [i*width, (i+1)*width) of
// little-endian uint32 words.
//
// A block stages a span of consecutive values (masked to `width` bits) in
// shared memory, then builds the words over them, one word a thread, so a
// warp stores 32 consecutive words (128 B). A word takes the at most
// ceil(32 / width) + 1 values that overlap it; its thread finds the first
// with a 32-bit divide of a bit offset relative to the span (no 64-bit
// divide). Four words a thread with 16-byte stores lost at every width:
// walked one after another they made a chain of 43 values at width 3,
// walked side by side they paid every step where a span is short (PERF.md
// §6). The staging puts value r at slot(r) = r + r / 32: threads whose
// words lie 32 / width values apart (32 apart at width 1) then read
// distinct banks.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace bitpack {

__host__ __device__ constexpr int slots(int values) { return values + values / 32; }

__device__ __forceinline__ int slot(int r) { return r + (r >> 5); }

__device__ __forceinline__ uint32_t mask_of(int width) {
  return width >= 32 ? 0xFFFFFFFFu : (1u << width) - 1u;
}

// Word q of a span: values s[slot(0 .. cnt - 1)], the first at bit d
// (0..31) of word 0.
__device__ __forceinline__ uint32_t word(const uint32_t* s, int cnt, int width, int d, int q) {
  const int lo = 32 * q - d;  // the span's bit at the word's first bit
  int r = lo <= 0 ? 0 : (int)((unsigned)lo / (unsigned)width);
  int b = r * width - lo;  // value r's first bit in the word, in (-width, 32)
  uint32_t x = 0;
  for (; b < 32 && r < cnt; ++r, b += width) {
    const uint32_t v = s[slot(r)];
    x |= b >= 0 ? v << b : v >> -b;
  }
  return x;
}

// A block's span: `cnt` values staged at s[slot(0 ..)], at bit positions
// [bit0, bit0 + cnt * width) of the output. Writes every word that holds
// bits of the span. A word part of which another block's span may set (its
// first word unless `own_lo` or bit0 is word-aligned, its last unless
// `own_hi` or the span ends on a word) is or-ed into a zeroed output with
// atomicOr; every other word is stored whole.
__device__ __forceinline__ void store_span(const uint32_t* s, int cnt, int width, long long bit0,
                                           bool own_lo, bool own_hi,
                                           uint32_t* __restrict__ out, int tid, int threads) {
  if (cnt <= 0 || width <= 0) return;
  const long long bit1 = bit0 + (long long)cnt * width;
  const long long j_lo = bit0 >> 5, j_hi = (bit1 + 31) >> 5;  // words [j_lo, j_hi)
  const int d = (int)(bit0 & 31);
  // a word is whole when the span covers all of it that any span can set
  const long long whole_lo = own_lo || d == 0 ? j_lo : j_lo + 1;
  const long long whole_hi = own_hi || (bit1 & 31) == 0 ? j_hi : j_hi - 1;
  for (long long j = j_lo + tid; j < j_hi; j += threads) {
    const uint32_t w = word(s, cnt, width, d, (int)(j - j_lo));
    if (j >= whole_lo && j < whole_hi) {
      out[j] = w;
    } else if (w) {
      atomicOr(out + j, w);
    }
  }
}

}  // namespace bitpack
