// Dictionary gather: out[i] = dict[idx[i]] for 4-byte and 8-byte elements.
//
// Replaces parquet_tpu/kernels/device_ops.py:dict_gather_device
// (`dictionary[indices]` under jax.jit). Floats travel as their 32/64-bit
// patterns, so one template on the element size serves every numeric type.
// Out-of-range indices do what jnp indexing does: a negative index wraps once
// (idx + D), then the index clamps into [0, D-1].
//
// Bound on an H100: memory, n * (4 + 2E) bytes (read the index, read the
// entry, write it). The index reads and the output writes are coalesced;
// the dictionary reads are random but a dictionary the main path sees
// (8 .. 100,000 entries of 4 or 8 bytes) fits in the 50 MB L2, so they hit
// cache after the first touch. Each thread handles consecutive elements in a
// grid-stride loop.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void dict_gather_kernel(const T* __restrict__ dict, long long d,
                                   const int32_t* __restrict__ idx, long long n,
                                   T* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    long long j = idx[i];
    if (j < 0) j += d;
    j = j < 0 ? 0 : (j >= d ? d - 1 : j);
    out[i] = dict[j];
  }
}

template <typename T>
int launch(const void* dict, long long d, const void* idx, long long n,
           void* out, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;
  dict_gather_kernel<T><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const T*)dict, d, (const int32_t*)idx, n, (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pqt_dict_gather4(const void* dict, long long d, const void* idx,
                                long long n, void* out, void* stream) {
  return launch<uint32_t>(dict, d, idx, n, out, stream);
}

extern "C" int pqt_dict_gather8(const void* dict, long long d, const void* idx,
                                long long n, void* out, void* stream) {
  return launch<unsigned long long>(dict, d, idx, n, out, stream);
}
