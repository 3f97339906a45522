// RLE / bit-packed hybrid expansion of a prescanned dictionary-index stream.
//
// Replaces parquet_tpu/kernels/device_ops.py:expand_hybrid_device (an XLA
// searchsorted + two-word gather + select chain). The input is the one packed
// upload that _HybridBatch.freeze builds (kernels/pipeline.py):
//
//   buf[0*run_pad : 1*run_pad]  is_rle     0/1
//   buf[1*run_pad : 2*run_pad]  out_start  exclusive cumsum of run counts (int32);
//                                          padding slots hold the sentinel n_pad+1
//   buf[2*run_pad : 3*run_pad]  rle_value  broadcast value of RLE runs
//   buf[3*run_pad : 4*run_pad]  bit_start  bit offset of the run's payload (int32)
//   buf[4*run_pad :]            packed payload words, plus one guard word
//
// One thread per output i: a binary search over out_start finds i's run r.
// An RLE run gives rle_value[r]; a bit-packed run reads the two 32-bit words
// at bitpos >> 5 and joins them with a funnel shift. width == 0 gives zeros
// (the XLA program returns zeros before the select, RLE runs included).
//
// Bound on an H100: memory. The work per output is a handful of integer ops;
// the bytes are the run tables (4 * 4 * run_pad), the packed words
// (width / 8 bytes per bit-packed output) and the 4-byte output. The design
// keeps the writes coalesced (neighbouring threads write neighbouring
// outputs, and read neighbouring packed words); the run search hits the same
// few table entries across a warp, so it is served from L1/L2. Staging the
// run table in shared memory, or one warp per run, is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void expand_hybrid_kernel(const uint32_t* __restrict__ buf,
                                     int run_pad, int width, int total,
                                     int32_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  if (width == 0) {
    out[i] = 0;
    return;
  }
  const int32_t* out_start = reinterpret_cast<const int32_t*>(buf + run_pad);
  // largest r with out_start[r] <= i (searchsorted side='right', minus one);
  // out_start[0] == 0, so r >= 0
  int lo = 0, hi = run_pad;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (out_start[mid] <= i) lo = mid + 1; else hi = mid;
  }
  const int r = lo - 1;
  uint32_t v;
  if (buf[r] != 0u) {
    v = buf[2 * run_pad + r];
  } else {
    const int32_t bit_start = reinterpret_cast<const int32_t*>(buf + 3 * run_pad)[r];
    const long long bitpos =
        (long long)bit_start + (long long)(i - out_start[r]) * width;
    const uint32_t* words = buf + 4 * run_pad;
    const long long w0 = bitpos >> 5;
    // (words[w0+1]:words[w0]) >> (bitpos & 31); the guard word makes w0+1 valid
    v = __funnelshift_r(words[w0], words[w0 + 1], (unsigned)(bitpos & 31));
    if (width < 32) v &= (1u << width) - 1u;
  }
  out[i] = (int32_t)v;
}

}  // namespace

extern "C" int pqt_expand_hybrid(const void* buf, int run_pad, int width,
                                 int total, void* out, void* stream) {
  if (total <= 0) return 0;
  const int threads = 256;
  const int blocks = (total + threads - 1) / threads;
  expand_hybrid_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)buf, run_pad, width, total, (int32_t*)out);
  return (int)cudaGetLastError();
}
