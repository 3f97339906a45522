// LSB-first bit-pack of uint32 values at a fixed width (0..32): value i lands
// at bits [i*width, (i+1)*width) of little-endian uint32 words, followed by
// one zero guard word (ceil(n*width/32) + 1 words in all).
//
// Replaces parquet_tpu/kernels/device_ops.py:bitpack_encode_device (under
// XLA: each value split into a lo and a hi word contribution, joined by a
// scatter-add). Values are masked to `width` bits (the callers pass values
// below 2^width, where the reference's add and this or agree). The write
// path packs inside rle_hybrid_encode.cu's placement, on the same word
// assembly (bitpack.cuh); this entry point is bitpack_encode's alone.
//
// Bound on an H100: memory. Bytes: the values read once (4 B each) and the
// packed words written once (n*width/8 B). One block a tile of kTile
// values: one 16-byte load a thread into shared memory, then the tile's
// words from there, one a thread (kTile * width / 32 = 32 * width whole
// words a tile, so no block shares a word with another). The parent took
// one thread a word straight from the values, two 64-bit divides and 3-4
// half-coalesced 4-byte loads (PERF.md §6).

#include <cstdint>
#include <cuda_runtime.h>

#include "bitpack.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 4 * kThreads;  // values a tile: device_ops.BITPACK_TILE

__global__ void __launch_bounds__(kThreads)
    pack(const uint32_t* __restrict__ v, long long n, int width, bool vec,
         uint32_t* __restrict__ out, long long n_words) {
  __shared__ uint32_t s[bitpack::slots(kTile)];
  const long long a = (long long)blockIdx.x * kTile;
  const int cnt = (int)(n - a < kTile ? n - a : kTile);
  const uint32_t mask = bitpack::mask_of(width);
  const int r0 = 4 * threadIdx.x;
  const long long p = a + r0;
  uint32_t x[4];
  if (vec && p + 4 <= n) {
    const uint4 q = *reinterpret_cast<const uint4*>(v + p);
    x[0] = q.x;
    x[1] = q.y;
    x[2] = q.z;
    x[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) x[k] = p + k < n ? v[p + k] : 0u;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) s[bitpack::slot(r0 + k)] = x[k] & mask;
  __syncthreads();
  bitpack::store_span(s, cnt, width, a * width, true, true, out, threadIdx.x, kThreads);
  if (blockIdx.x == gridDim.x - 1 && threadIdx.x == 0) out[n_words - 1] = 0u;  // the guard word
}

}  // namespace

// values: uint32[n]; out: uint32[n_words], n_words = ceil(n*width/32) + 1,
// or one word when width or n is 0.
extern "C" int pqt_bitpack_encode(const void* values, long long n, int width, void* out,
                                  long long n_words, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (width < 0 || width > 32 || n_words <= 0) return (int)cudaErrorInvalidValue;
  if (width == 0 || n <= 0)
    return (int)cudaMemsetAsync(out, 0, (size_t)n_words * sizeof(uint32_t), s);
  pack<<<(unsigned)((n + kTile - 1) / kTile), kThreads, 0, s>>>(
      (const uint32_t*)values, n, width, (uintptr_t)values % 16 == 0, (uint32_t*)out, n_words);
  return (int)cudaGetLastError();
}
