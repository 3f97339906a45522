// BYTE_STREAM_SPLIT de-interleave of a 4-byte page: out[i] is the
// little-endian word of bytes streams[0][i], streams[1][i], streams[2][i],
// streams[3][i].
//
// Replaces parquet_tpu/kernels/device_ops.py:bss_transpose_device and its
// jitted _bss_transpose_padded (a (4, n_pad) -> (n_pad, 4) transpose and a
// bitcast under XLA). The input is the (4, n_pad) uint8 staging the host
// builds per page (kernels/pipeline._plan_from_tables, four contiguous
// memcpys); the port writes exactly num_values words, not the padded bucket.
//
// Bound on an H100: memory, 8 bytes per value (four stream bytes read, one
// word written). One thread per value: a warp reads 32 consecutive bytes of
// each stream (coalesced) and writes 128 consecutive bytes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void bss_transpose_kernel(const uint8_t* __restrict__ streams,
                                     long long n_pad, long long n,
                                     uint32_t* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const uint32_t b0 = streams[i];
    const uint32_t b1 = streams[n_pad + i];
    const uint32_t b2 = streams[2 * n_pad + i];
    const uint32_t b3 = streams[3 * n_pad + i];
    out[i] = b0 | (b1 << 8) | (b2 << 16) | (b3 << 24);
  }
}

}  // namespace

extern "C" int pqt_bss_transpose(const void* streams, long long n_pad,
                                 long long n, void* out, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;
  bss_transpose_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)streams, n_pad, n, (uint32_t*)out);
  return (int)cudaGetLastError();
}
