// Mixed dict/PLAIN byte-array merge: the ragged (data, offsets) column of a
// chunk whose dictionary pages and PLAIN pages interleave.
//
// Replaces parquet_tpu/kernels/device_ops.py:merge_mixed_bytes_device (under
// XLA: a per-row searchsorted and gathers, a cumsum, then a searchsorted per
// OUTPUT BYTE into the offsets to find each byte's row). Here:
//
//   1. rows_scan: one item per row finds the row's page (binary search over
//      the page row starts), its source start and length: a dict row reads
//      doff[idx_all[aux + rel]], a PLAIN row reads po32[aux + rel] and
//      po32[aux + rel + 1] plus its page's byte base in the pool. The starts
//      go to scratch; the lengths are scanned within the block
//      (cub::BlockScan, 256 threads x 4 items) and the block totals saved.
//   2. scan_blocks: one block scans the block totals (exclusive).
//   3. add_prefix: offsets[i + 1] = block prefix + local inclusive scan;
//      offsets[0] = 0. (1-3 are delta_packed_decode.cu's block-sum scan.)
//   4. copy: a warp per row copies its bytes, lanes on consecutive bytes.
//
// The JAX pipeline pads its inputs to buckets (idx_all with zeros, the
// dictionary offsets with their last value, the PLAIN offsets with zeros)
// and the program clamps against the padded shapes. The kernel replicates
// those reads from the padded sizes (d_pad, doff_pad, e_pad) without the
// padding: an index past the dictionary reads an empty entry.
//
// Bound on an H100: memory. Bytes: the dict rows' indices, the dictionary
// offsets and payload, the PLAIN offsets and payload, the output bytes and
// offsets, each once. The starts scratch (8 B a row, written and read) and
// the warp-per-row copy of short strings (about 17 of 32 lanes busy on the
// main path's zone names) are what this simple design spends beyond it.

#include <cstdint>
#include <cuda_runtime.h>
#include <cub/block/block_scan.cuh>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;
constexpr int kScanThreads = 256;

struct Args {
  const int32_t* idx_all;
  long long d, d_pad;
  const long long* doff;
  long long n_doff, doff_pad;
  const uint8_t* pool;
  long long n_pool;
  const int32_t* po32;
  long long e, e_pad;
  const int32_t* page_kind;
  const int32_t* prs;
  const int32_t* aux;
  const long long* src_base;
  int p_pad;
  long long n_rows;
};

__device__ __forceinline__ long long clampll(long long x, long long lo, long long hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// (start, length) of row i
__device__ __forceinline__ long long row_source(const Args& a, long long i,
                                                long long* start) {
  int lo = 0, hi = a.p_pad;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((long long)__ldg(a.prs + 1 + mid) <= i) lo = mid + 1; else hi = mid;
  }
  const int pg = lo < a.p_pad - 1 ? lo : a.p_pad - 1;
  const long long src = (long long)__ldg(a.aux + pg) + (i - (long long)__ldg(a.prs + pg));
  long long len;
  if (__ldg(a.page_kind + pg) == 1) {
    const long long j = clampll(src, 0, a.d_pad - 1);
    long long k = j < a.d ? (long long)a.idx_all[j] : 0;
    k = clampll(k, 0, a.doff_pad - 2);
    const long long last = a.n_doff - 1;
    const long long s = a.doff[k < last ? k : last];
    *start = s;
    len = a.doff[k + 1 < last ? k + 1 : last] - s;
  } else {
    const long long e = clampll(src, 0, a.e_pad - 2);
    const long long p0 = e < a.e ? (long long)a.po32[e] : 0;
    const long long p1 = e + 1 < a.e ? (long long)a.po32[e + 1] : 0;
    *start = p0 + a.src_base[pg];
    len = p1 - p0;
  }
  return len > 0 ? len : 0;
}

__global__ void __launch_bounds__(kThreads)
    rows_scan(Args a, long long* __restrict__ offsets, long long* __restrict__ starts,
              long long* __restrict__ block_sums) {
  using BlockScan = cub::BlockScan<long long, kThreads>;
  __shared__ typename BlockScan::TempStorage temp;
  const long long base =
      (long long)blockIdx.x * kTile + (long long)threadIdx.x * kItems;
  long long items[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + k;
    items[k] = 0;
    if (i < a.n_rows) {
      long long s;
      items[k] = row_source(a, i, &s);
      starts[i] = s;
    }
  }
  long long agg;
  BlockScan(temp).InclusiveSum(items, items, agg);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + k;
    if (i < a.n_rows) offsets[i + 1] = items[k];
  }
  if (threadIdx.x == 0) block_sums[blockIdx.x] = agg;
}

// One block of kScanThreads (64-bit CUB scans need the register cap).
__global__ void __launch_bounds__(kScanThreads)
    scan_blocks(long long* __restrict__ block_sums, int nblocks) {
  using BlockScan = cub::BlockScan<long long, kScanThreads>;
  __shared__ typename BlockScan::TempStorage temp;
  __shared__ long long carry;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < nblocks; base += kScanThreads) {
    const int j = base + threadIdx.x;
    const long long x = j < nblocks ? block_sums[j] : 0;
    long long excl, agg;
    BlockScan(temp).ExclusiveSum(x, excl, agg);
    const long long before = carry;
    if (j < nblocks) block_sums[j] = excl + before;
    __syncthreads();
    if (threadIdx.x == 0) carry = before + agg;
    __syncthreads();
  }
}

__global__ void add_prefix(long long* __restrict__ offsets,
                           const long long* __restrict__ block_sums, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i == 0) offsets[0] = 0;
  if (i < n) offsets[i + 1] += block_sums[i / kTile];
}

__global__ void copy_rows(Args a, const long long* __restrict__ offsets,
                          const long long* __restrict__ starts,
                          long long data_bytes, uint8_t* __restrict__ data) {
  const int lane = threadIdx.x & 31;
  const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long r = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       r < a.n_rows; r += warps) {
    const long long dst = offsets[r];
    const long long len = offsets[r + 1] - dst;
    const long long s = starts[r];
    for (long long k = lane; k < len; k += 32) {
      if (dst + k < data_bytes) data[dst + k] = a.pool[clampll(s + k, 0, a.n_pool - 1)];
    }
  }
}

}  // namespace

// Rows per block of pass 1: the wrapper sizes the block-sum scratch with it.
extern "C" int pqt_merge_bytes_tile() { return kTile; }

extern "C" int pqt_merge_mixed_bytes(
    const void* idx_all, long long d, long long d_pad, const void* doff,
    long long n_doff, long long doff_pad, const void* pool, long long n_pool,
    const void* po32, long long e, long long e_pad, const void* page_kind,
    const void* prs, const void* aux, const void* src_base, int p_pad,
    long long n_rows, long long data_bytes, void* data, void* offsets,
    void* starts, void* block_sums, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  long long* off = (long long*)offsets;
  if (n_rows <= 0) return (int)cudaMemsetAsync(off, 0, sizeof(long long), s);
  Args a;
  a.idx_all = (const int32_t*)idx_all;
  a.d = d;
  a.d_pad = d_pad;
  a.doff = (const long long*)doff;
  a.n_doff = n_doff;
  a.doff_pad = doff_pad;
  a.pool = (const uint8_t*)pool;
  a.n_pool = n_pool;
  a.po32 = (const int32_t*)po32;
  a.e = e;
  a.e_pad = e_pad;
  a.page_kind = (const int32_t*)page_kind;
  a.prs = (const int32_t*)prs;
  a.aux = (const int32_t*)aux;
  a.src_base = (const long long*)src_base;
  a.p_pad = p_pad;
  a.n_rows = n_rows;
  long long* bs = (long long*)block_sums;
  long long* st = (long long*)starts;
  const long long nblocks = (n_rows + kTile - 1) / kTile;
  rows_scan<<<(unsigned)nblocks, kThreads, 0, s>>>(a, off, st, bs);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  scan_blocks<<<1, kScanThreads, 0, s>>>(bs, (int)nblocks);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  add_prefix<<<(unsigned)((n_rows + 255) / 256), 256, 0, s>>>(off, bs, n_rows);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  long long cblocks = (n_rows * 32 + 255) / 256;
  if (cblocks > 65535LL * 32) cblocks = 65535LL * 32;
  copy_rows<<<(unsigned)cblocks, 256, 0, s>>>(a, off, st, data_bytes,
                                             (uint8_t*)data);
  return (int)cudaGetLastError();
}
