// PLAIN framing of a byte-array column: `<4-byte LE length><bytes>` per
// value, value i at 4*i + off[i] - off[0].
//
// Replaces parquet_tpu/kernels/device_ops.py:plain_bytearray_encode_device
// (under XLA: a searchsorted of every output byte into the framed value
// starts, then header bytes from the offset diffs and payload bytes gathered
// out of `data`, into a zero-padded bucket). Here one thread per value
// writes its header and copies its bytes; the output is exactly the framed
// stream (out_len bytes, positions past it dropped).
//
// Bound on an H100: memory. Bytes: the offsets read (8 B per value), the
// data read once and the stream written once (data + 4 B per value). A
// thread's byte loop leaves the stores uncoalesced across the warp; a warp
// per value for long values is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void frame(const uint8_t* __restrict__ data, const long long* __restrict__ off,
                      long long n, long long out_len, uint8_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long a = off[i];
  const long long len = off[i + 1] - a;
  const long long p = 4 * i + a - off[0];
  for (int k = 0; k < 4; ++k)
    if (p + k < out_len) out[p + k] = (uint8_t)((unsigned long long)len >> (8 * k));
  for (long long j = 0; j < len && p + 4 + j < out_len; ++j) out[p + 4 + j] = data[a + j];
}

}  // namespace

// data: uint8; offsets: int64[n + 1]; out: uint8[out_len].
extern "C" int pqt_plain_bytearray_encode(const void* data, const void* offsets, long long n,
                                          long long out_len, void* out, void* stream) {
  if (n <= 0) return 0;
  frame<<<(unsigned)((n + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)data, (const long long*)offsets, n, out_len, (uint8_t*)out);
  return (int)cudaGetLastError();
}
