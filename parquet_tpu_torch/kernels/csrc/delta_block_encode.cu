// DELTA_BINARY_PACKED encode of one page of int32/int64 values: the block
// tables and the packed payload, for blocks of 128 deltas in 4 miniblocks
// of 32 (ops/delta.encode_delta's policy).
//
// Replaces parquet_tpu/kernels/device_ops.py:delta_block_encode_device
// (under XLA: a shifted subtract, reshape min and max, clz, a cumsum of
// payload sizes and a scatter-add of lo/hi word contributions over a padded
// bucket). Here the tables cover exactly the page's ceil((n - 1) / 128)
// blocks:
//
//   1. block_tables, one 128-thread block per delta block: thread t takes
//      delta d = v[i+1] - v[i] (wrapping, unsigned), the block's signed
//      minimum comes from warp shuffles and shared memory (INT_MAX stands in
//      for lanes past the deltas), each warp (one miniblock) reduces
//      max(d - min) (unsigned) and writes its width, nbits - clz(max).
//   2. one scan.cuh scan (int64) of 4 * width over the page's miniblocks:
//      each miniblock's payload byte offset. A miniblock of 32 values at
//      width w is exactly w 32-bit words, so every payload starts on a word.
//   3. pack_blocks, one 128-thread block per delta block: the block's 128
//      adjusted deltas go to shared memory, and warp q packs miniblock q's w
//      words (lane j writes words j and j + 32), each word gathering the
//      values whose bits overlap it. No two threads write one word: no
//      atomics.
//
// The words past the last payload are not written: the caller reads
// sum(widths) words. Pages of n <= 1 have no deltas and launch nothing.
//
// Bound on an H100: memory. Bytes: the values read once (4 or 8 B; each is
// read again as its neighbour's operand and by pass 3, from L2), the tables
// written (mins 4 or 8 B per 128 values, widths 4 B per 32) and the payload
// written once (width / 8 B per value).

#include "scan.cuh"

namespace {

constexpr int kBlock = 128;

template <typename S>
__device__ __forceinline__ S warp_min(S x) {
  for (int o = 16; o > 0; o >>= 1) {
    const S y = __shfl_xor_sync(0xFFFFFFFFu, x, o);
    x = y < x ? y : x;
  }
  return x;
}

template <typename U>
__device__ __forceinline__ U warp_max(U x) {
  for (int o = 16; o > 0; o >>= 1) {
    const U y = __shfl_xor_sync(0xFFFFFFFFu, x, o);
    x = y > x ? y : x;
  }
  return x;
}

__device__ __forceinline__ int bit_length(uint32_t x) { return x ? 32 - __clz((int)x) : 0; }
__device__ __forceinline__ int bit_length(unsigned long long x) {
  return x ? 64 - __clzll((long long)x) : 0;
}

template <typename U, typename S>
__global__ void __launch_bounds__(kBlock)
    block_tables(const U* __restrict__ v, long long nd, S* __restrict__ mins,
                 int32_t* __restrict__ widths) {
  __shared__ S warp_mins[kBlock / 32];
  const long long blk = blockIdx.x;
  const int t = threadIdx.x;
  const long long i = blk * kBlock + t;
  const bool valid = i < nd;
  const U d = valid ? (U)(v[i + 1] - v[i]) : U(0);
  const S big = (S)(((U)~U(0)) >> 1);
  S m = warp_min<S>(valid ? (S)d : big);
  if ((t & 31) == 0) warp_mins[t >> 5] = m;
  __syncthreads();
  m = warp_mins[0];
  for (int q = 1; q < kBlock / 32; ++q) m = warp_mins[q] < m ? warp_mins[q] : m;
  if (t == 0) mins[blk] = m;
  const U adj = valid ? (U)(d - (U)m) : U(0);
  const U mx = warp_max<U>(adj);
  if ((t & 31) == 0) widths[blk * 4 + (t >> 5)] = bit_length(mx);
}

struct PayloadBytes {
  const int32_t* widths;
  __device__ long long operator()(long long m) const { return 4LL * widths[m]; }
};

struct PayloadStart {
  const int32_t* widths;
  long long* offs;
  __device__ void operator()(long long m, long long incl, long long) const {
    offs[m] = incl - 4LL * widths[m];
  }
};

template <typename U, typename S>
__global__ void __launch_bounds__(kBlock)
    pack_blocks(const U* __restrict__ v, long long nd, const S* __restrict__ mins,
                const int32_t* __restrict__ widths, const long long* __restrict__ offs,
                uint32_t* __restrict__ words) {
  __shared__ U adj[kBlock];
  const long long blk = blockIdx.x;
  const int t = threadIdx.x;
  const long long i = blk * kBlock + t;
  adj[t] = i < nd ? (U)((U)(v[i + 1] - v[i]) - (U)mins[blk]) : U(0);
  __syncthreads();
  const int q = t >> 5, lane = t & 31;
  const int w = widths[blk * 4 + q];
  uint32_t* out = words + offs[blk * 4 + q] / 4;
  const U* a = adj + q * 32;
  for (int j = lane; j < w; j += 32) {
    const int lo_bit = j * 32;
    int k = lo_bit / w;
    int k_end = (lo_bit + 32 + w - 1) / w;
    if (k_end > 32) k_end = 32;
    uint32_t word = 0;
    for (; k < k_end; ++k) {
      const unsigned long long x = (unsigned long long)a[k];
      const int b = k * w - lo_bit;  // in (-w, 32)
      word |= b >= 0 ? (uint32_t)(x << b) : (uint32_t)(x >> -b);
    }
    out[j] = word;
  }
}

template <typename U, typename S>
int launch(const void* values, long long n, void* mins, void* widths, void* offs,
           void* tile_sums, void* words, cudaStream_t s) {
  const long long nd = n - 1;
  const long long nb = (nd + kBlock - 1) / kBlock;
  block_tables<U, S><<<(unsigned)nb, kBlock, 0, s>>>((const U*)values, nd, (S*)mins,
                                                      (int32_t*)widths);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  rc = scan::run<long long>(PayloadBytes{(const int32_t*)widths},
                            PayloadStart{(const int32_t*)widths, (long long*)offs}, 4 * nb,
                            (long long*)offs, (long long*)tile_sums, s);
  if (rc) return rc;
  pack_blocks<U, S><<<(unsigned)nb, kBlock, 0, s>>>((const U*)values, nd, (const S*)mins,
                                                     (const int32_t*)widths,
                                                     (const long long*)offs,
                                                     (uint32_t*)words);
  return (int)cudaGetLastError();
}

}  // namespace

// values: n int32 (nbits 32) or int64 (nbits 64); with nb = ceil((n-1)/128)
// blocks: mins: nb of the values' type; widths: int32[4 nb]; offs: int64[4 nb]
// (scratch: payload byte offsets); tile_sums: the int64 scan's scratch;
// words: uint32[4 nb nbits], room for the widest payload; the first
// sum(widths) are written.
extern "C" int pqt_delta_block_encode(const void* values, long long n, int nbits, void* mins,
                                      void* widths, void* offs, void* tile_sums, void* words,
                                      void* stream) {
  if (n <= 1) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (nbits == 32)
    return launch<uint32_t, int32_t>(values, n, mins, widths, offs, tile_sums, words, s);
  if (nbits == 64)
    return launch<unsigned long long, long long>(values, n, mins, widths, offs, tile_sums, words,
                                                 s);
  return (int)cudaErrorInvalidValue;
}
