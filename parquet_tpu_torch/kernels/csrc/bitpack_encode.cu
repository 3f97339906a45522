// LSB-first bit-pack of uint32 values at a fixed width (0..32): value i lands
// at bits [i*width, (i+1)*width) of little-endian uint32 words, followed by
// one zero guard word (ceil(n*width/32) + 1 words in all).
//
// Replaces parquet_tpu/kernels/device_ops.py:bitpack_encode_device (under
// XLA: each value split into a lo and a hi word contribution, joined by a
// scatter-add). Here each thread owns one output word and gathers the at
// most 33 values whose bits overlap it, so no two threads write one word and
// no atomic is needed. Values are masked to `width` bits (the callers pass
// values below 2^width, where the reference's add and this or agree).
//
// Bound on an H100: memory. Bytes: the values read once (4 B each; the
// neighbouring words' threads re-read a boundary value from L1/L2) and the
// packed words written once (n*width/8 B).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void pack(const uint32_t* __restrict__ v, long long n, int width,
                     long long n_words, uint32_t* __restrict__ out) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n_words) return;
  const long long lo_bit = j * 32;
  long long i = lo_bit / width;
  long long i_end = (lo_bit + 32 + width - 1) / width;  // values starting before lo_bit + 32
  if (i_end > n) i_end = n;
  const uint64_t mask = width == 32 ? 0xFFFFFFFFull : ((1ull << width) - 1);
  uint32_t w = 0;
  for (; i < i_end; ++i) {
    const uint64_t x = (uint64_t)v[i] & mask;
    const long long b = i * width - lo_bit;  // in (-width, 32)
    w |= b >= 0 ? (uint32_t)(x << b) : (uint32_t)(x >> -b);
  }
  out[j] = w;
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
  pack<<<(unsigned)((n_words + 255) / 256), 256, 0, s>>>((const uint32_t*)values, n, width,
                                                          n_words, (uint32_t*)out);
  return (int)cudaGetLastError();
}
