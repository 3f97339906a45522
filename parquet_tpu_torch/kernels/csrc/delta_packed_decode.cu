// DELTA_BINARY_PACKED decode of a whole chunk from wire words, 32 and 64 bit.
//
// Replaces parquet_tpu/kernels/device_ops.py:delta_packed_decode_device (an
// XLA chain: two searchsorteds, a dynamic-width two-word gather, a wrapping
// cumsum and a per-page rebase). The inputs are the uploads that
// _DeltaBatch.freeze lays out (kernels/pipeline.py):
//
//   meta32  [widths(m) | bit_starts(m) | out_starts(m) | page_start(p)]
//           + for nbits=32: [mins(m) | page_first(p) | wire words]
//   wide    for nbits=64: [mins(m) | page_first(p) | wire words] as uint64
//
// Padding slots of out_starts and page_start hold the sentinel n_pad+1. The
// first value of each page sits in no miniblock (its out_starts are page
// start + 1 onward) and contributes 0 to the scan. With C the inclusive scan
// of the per-position deltas d, in wrapping unsigned arithmetic:
//
//   value[i] = page_first[p] + C[i] - C[page_start[p]]
//
// Four passes:
//   1. per element: find miniblock m and page p (binary searches), unpack w
//      bits from two words, add mb_min[m]; zero at page starts; scan within
//      the block (cub::BlockScan: warp shuffles + shared memory); write the
//      block-local scan to the scratch C and the block total.
//   2. one block scans the block totals (exclusive).
//   3. C[i] += exclusive prefix of its block: the global inclusive scan.
//   4. value[i] = page_first[p] + C[i] - C[page_start[p]], read from the
//      scratch C (another thread's C[page_start] is read, so not in place).
//
// Bound on an H100: memory. Bytes: the wire words and tables read, n * E
// written, plus the scratch C written and read (E = 4 or 8). The integer work
// per element is small. The design spends two extra passes over C (3 and 4)
// to stay simple; folding pass 3 into pass 4 and a decoupled look-back scan
// are later work.

#include <cstdint>
#include <cuda_runtime.h>
#include <cub/block/block_scan.cuh>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;
constexpr int kScanThreads = 256;

// largest r in [0, n) with a[r] <= x, or -1 (searchsorted side='right' - 1)
__device__ __forceinline__ int search(const int32_t* a, int n, long long x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((long long)a[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo - 1;
}

template <typename U>
struct Tables {
  const uint32_t* width;
  const int32_t* bit_start;
  const int32_t* out_start;
  const int32_t* page_start;
  const U* mb_min;
  const U* page_first;
  const U* words;
  int m_pad;
  int p_pad;
};

__device__ __forceinline__ uint32_t unpack(const uint32_t* words, long long bitpos,
                                           uint32_t w) {
  const long long w0 = bitpos >> 5;
  const uint32_t v =
      __funnelshift_r(words[w0], words[w0 + 1], (unsigned)(bitpos & 31));
  return w >= 32 ? v : (v & ((1u << w) - 1u));
}

__device__ __forceinline__ unsigned long long unpack(
    const unsigned long long* words, long long bitpos, uint32_t w) {
  const long long w0 = bitpos >> 6;
  const unsigned s = (unsigned)(bitpos & 63);
  const unsigned long long lo = words[w0] >> s;
  const unsigned long long hi = s == 0 ? 0ull : (words[w0 + 1] << (64 - s));
  const unsigned long long v = lo | hi;
  return w >= 64 ? v : (v & ((1ull << w) - 1ull));
}

template <typename U>
__device__ __forceinline__ U delta_at(const Tables<U>& t, long long i) {
  const int p = search(t.page_start, t.p_pad, i);
  if (p < 0 || t.page_start[p] == i) return U(0);
  const int m = search(t.out_start, t.m_pad, i);
  if (m < 0) return U(0);
  const uint32_t w = t.width[m];
  const long long bitpos =
      (long long)t.bit_start[m] + (i - (long long)t.out_start[m]) * (long long)w;
  return unpack(t.words, bitpos, w) + t.mb_min[m];
}

template <typename U>
__global__ void __launch_bounds__(kThreads)
    pass1_local_scan(Tables<U> t, int total, U* __restrict__ c,
                     U* __restrict__ block_sums) {
  using BlockScan = cub::BlockScan<U, kThreads>;
  __shared__ typename BlockScan::TempStorage temp;
  const long long base =
      (long long)blockIdx.x * kTile + (long long)threadIdx.x * kItems;
  U items[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + k;
    items[k] = i < total ? delta_at(t, i) : U(0);
  }
  U agg;
  BlockScan(temp).InclusiveSum(items, items, agg);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + k;
    if (i < total) c[i] = items[k];
  }
  if (threadIdx.x == 0) block_sums[blockIdx.x] = agg;
}

// One block of kScanThreads (64-bit CUB scans need the register cap: 1024
// threads asked for more registers than an SM has).
template <typename U>
__global__ void __launch_bounds__(kScanThreads)
    pass2_scan_blocks(U* __restrict__ block_sums, int nblocks) {
  using BlockScan = cub::BlockScan<U, kScanThreads>;
  __shared__ typename BlockScan::TempStorage temp;
  __shared__ U carry;
  if (threadIdx.x == 0) carry = U(0);
  __syncthreads();
  for (int base = 0; base < nblocks; base += kScanThreads) {
    const int j = base + threadIdx.x;
    const U x = j < nblocks ? block_sums[j] : U(0);
    U excl, agg;
    BlockScan(temp).ExclusiveSum(x, excl, agg);
    const U before = carry;
    if (j < nblocks) block_sums[j] = excl + before;
    __syncthreads();
    if (threadIdx.x == 0) carry = before + agg;
    __syncthreads();
  }
}

template <typename U>
__global__ void pass3_add_prefix(U* __restrict__ c, const U* __restrict__ block_sums,
                                 int total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < total) c[i] += block_sums[i / kTile];
}

template <typename U>
__global__ void pass4_rebase(Tables<U> t, const U* __restrict__ c, int total,
                             U* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int p = search(t.page_start, t.p_pad, i);
  out[i] = t.page_first[p] + c[i] - c[t.page_start[p]];
}

template <typename U>
int run(const Tables<U>& t, int total, U* out, U* c, U* block_sums,
        cudaStream_t stream) {
  const int nblocks = (total + kTile - 1) / kTile;
  pass1_local_scan<U><<<nblocks, kThreads, 0, stream>>>(t, total, c, block_sums);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  pass2_scan_blocks<U><<<1, kScanThreads, 0, stream>>>(block_sums, nblocks);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  const int eblocks = (total + 255) / 256;
  pass3_add_prefix<U><<<eblocks, 256, 0, stream>>>(c, block_sums, total);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  pass4_rebase<U><<<eblocks, 256, 0, stream>>>(t, c, total, out);
  return (int)cudaGetLastError();
}

}  // namespace

// Elements per block of pass 1: the wrapper sizes the block-sum scratch with it.
extern "C" int pqt_delta_tile() { return kTile; }

extern "C" int pqt_delta_packed_decode(const void* meta32_v, const void* wide_v,
                                       int nbits, int m_pad, int p_pad, int total,
                                       void* out, void* scratch_c,
                                       void* block_sums, void* stream) {
  if (total <= 0) return 0;
  const uint32_t* meta32 = (const uint32_t*)meta32_v;
  const cudaStream_t s = (cudaStream_t)stream;
  if (nbits == 32) {
    Tables<uint32_t> t;
    t.width = meta32;
    t.bit_start = (const int32_t*)(meta32 + m_pad);
    t.out_start = (const int32_t*)(meta32 + 2 * m_pad);
    t.page_start = (const int32_t*)(meta32 + 3 * m_pad);
    t.mb_min = meta32 + 3 * m_pad + p_pad;
    t.page_first = meta32 + 4 * m_pad + p_pad;
    t.words = meta32 + 4 * m_pad + 2 * p_pad;
    t.m_pad = m_pad;
    t.p_pad = p_pad;
    return run<uint32_t>(t, total, (uint32_t*)out, (uint32_t*)scratch_c,
                         (uint32_t*)block_sums, s);
  }
  if (nbits == 64) {
    const unsigned long long* wide = (const unsigned long long*)wide_v;
    Tables<unsigned long long> t;
    t.width = meta32;
    t.bit_start = (const int32_t*)(meta32 + m_pad);
    t.out_start = (const int32_t*)(meta32 + 2 * m_pad);
    t.page_start = (const int32_t*)(meta32 + 3 * m_pad);
    t.mb_min = wide;
    t.page_first = wide + m_pad;
    t.words = wide + m_pad + p_pad;
    t.m_pad = m_pad;
    t.p_pad = p_pad;
    return run<unsigned long long>(t, total, (unsigned long long*)out,
                                   (unsigned long long*)scratch_c,
                                   (unsigned long long*)block_sums, s);
  }
  return (int)cudaErrorInvalidValue;
}
