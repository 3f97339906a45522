// Page-grid expansion: a padded (P, W) grid of hybrid RLE/bit-packed index
// pages expanded to (P, n_out) indices and gathered from a dictionary, in one
// pass with one thread per output.
//
// Replaces parquet_tpu/parallel/mesh.py:_expand_one_page, vmapped over a
// device's pages in sharded_decode_step, and the dictionary gather after it
// (`dict_dev[idx]`). Per output i of page p:
//   r      = (number of starts[p, :] <= i) - 1, clipped to [0, R-1], found by
//            a binary search (the grid pads starts with n_out + 1, and a
//            padding page is all zeros, so every row is non-decreasing);
//   bitpos = bit_starts[p, r] + (i - starts[p, r]) * width, in int32 with
//            wrap-around, as the JAX program computes it;
//   the two words at w0 = bitpos >> 5 and min(w0 + 1, W - 1), each index
//            wrapped once if negative and clamped into [0, W-1], as XLA's
//            gather does;
//   idx    = values[p, r] where is_rle[p, r] == 1, else the bits masked to
//            width (all ones at 32, none at 0);
//   out    = dictionary[clamp(int32(idx), 0, D-1)]: XLA gathers with the
//            uint32 index read as int32 and clamps (no wrap of negatives).
// Positions past a page's real count get exactly what the JAX program
// computes there. Floats travel as their 32/64-bit patterns.
//
// Bound on an H100: memory, P * n_out * E bytes written plus the grid's
// words and run tables read once (the dictionary, 4,096 doubles on the main
// path, stays in L2). The binary search over a page's R run starts reads
// L1-resident rows; neighbouring threads share a page and mostly a run, so
// the word loads coalesce.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ long long wrap_clamp(int j, int len) {
  long long k = j < 0 ? (long long)j + len : (long long)j;
  return k < 0 ? 0 : (k >= len ? len - 1 : k);
}

template <typename T>
__global__ void __launch_bounds__(256)
    expand_page_grid_kernel(const uint32_t* __restrict__ words, int W,
                            const int32_t* __restrict__ starts,
                            const int32_t* __restrict__ is_rle,
                            const uint32_t* __restrict__ values,
                            const int32_t* __restrict__ bit_starts, int R, int width,
                            const T* __restrict__ dict, long long D, int P, int n_out,
                            T* __restrict__ out) {
  const long long total = (long long)P * n_out;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const uint32_t vmask = width >= 32 ? 0xFFFFFFFFu : ((1u << width) - 1u);
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += stride) {
    const int p = (int)(t / n_out);
    const int i = (int)(t - (long long)p * n_out);
    const int32_t* st = starts + (long long)p * R;
    int lo = 0, hi = R;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (st[mid] <= i) lo = mid + 1;
      else hi = mid;
    }
    int r = lo - 1;
    r = r < 0 ? 0 : (r > R - 1 ? R - 1 : r);
    const long long pr = (long long)p * R + r;
    const uint32_t within = (uint32_t)i - (uint32_t)st[r];
    const int bitpos = (int)((uint32_t)bit_starts[pr] + within * (uint32_t)width);
    const int w0 = bitpos >> 5;
    const uint32_t s = (uint32_t)bitpos & 31u;
    const uint32_t* row = words + (long long)p * W;
    const uint32_t lo_w = row[wrap_clamp(w0, W)] >> s;
    const int w1 = w0 + 1 < W - 1 ? w0 + 1 : W - 1;
    const uint32_t hi_w = s == 0 ? 0u : row[wrap_clamp(w1, W)] << ((32u - s) & 31u);
    const uint32_t idx = is_rle[pr] == 1 ? values[pr] : ((lo_w | hi_w) & vmask);
    const long long j = (long long)(int32_t)idx;
    out[t] = dict[j < 0 ? 0 : (j >= D ? D - 1 : j)];
  }
}

template <typename T>
int launch(const void* words, int W, const void* starts, const void* is_rle,
           const void* values, const void* bit_starts, int R, int width, const void* dict,
           long long D, int P, int n_out, void* out, void* stream) {
  const long long total = (long long)P * n_out;
  if (total <= 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;
  expand_page_grid_kernel<T><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, W, (const int32_t*)starts, (const int32_t*)is_rle,
      (const uint32_t*)values, (const int32_t*)bit_starts, R, width, (const T*)dict, D, P,
      n_out, (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// words (P, W), starts / is_rle / values / bit_starts (P, R), all 4-byte and
// C-contiguous; dict of D elements of 4 (elem 4) or 8 bytes; out (P, n_out).
extern "C" int pqt_expand_page_grid(const void* words, int W, const void* starts,
                                    const void* is_rle, const void* values,
                                    const void* bit_starts, int R, int width,
                                    const void* dict, long long D, int elem, int P, int n_out,
                                    void* out, void* stream) {
  if (elem == 4)
    return launch<uint32_t>(words, W, starts, is_rle, values, bit_starts, R, width, dict, D,
                            P, n_out, out, stream);
  return launch<unsigned long long>(words, W, starts, is_rle, values, bit_starts, R, width,
                                    dict, D, P, n_out, out, stream);
}
