// Device-wide inclusive prefix scan over int32 or int64, in three passes:
//
//   1. tile_scan: each block of kThreads x kItems elements loads its items
//      through a functor, scans them (cub::BlockScan: warp shuffles and
//      shared memory), writes the tile-local inclusive scan to `partial`
//      and the tile's total to tile_sums[tile].
//   2. scan_tile_sums: one block turns tile_sums into exclusive prefixes, in
//      place, and writes the grand total to tile_sums[ntiles].
//   3. add_pass: one thread per element adds its tile's prefix and hands
//      (i, inclusive scan, grand total) to an epilogue functor, which writes
//      the caller's outputs.
//
// The caller owns the scratch: `partial` (n elements of T; it may be an
// output of the epilogue itself, which may overwrite partial[i] in the
// thread that reads it) and `tile_sums` (num_tiles(n) + 1 elements of T);
// wrappers size the latter with pqt_scan_tile() (record_starts.cu). Nothing
// here allocates or synchronizes; every launch goes to the given stream.
//
// Used by record_starts.cu, list_layout.cu, pad_ragged.cu and
// expand_nullable.cu. A load functor is `T operator()(long long i) const`,
// called for i < n; an epilogue is `void operator()(long long i, T incl,
// T total) const`. Sums are exact as long as they fit T (the wrappers keep
// n below 2^31).
//
// Bound on an H100: memory. Pass 1 reads the inputs and writes `partial`,
// pass 3 reads it back: 2 x sizeof(T) bytes per element beyond the inputs
// and outputs. A decoupled look-back scan (one pass) is later work. 64-bit
// scans need the 256-thread cap of __launch_bounds__ (a 1,024-thread
// 64-bit BlockScan asked for more registers than an SM has).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <cub/block/block_scan.cuh>

namespace {
namespace scan {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;

inline long long num_tiles(long long n) { return (n + kTile - 1) / kTile; }

template <typename T, typename Load>
__global__ void __launch_bounds__(kThreads)
    tile_scan(Load load, long long n, T* __restrict__ partial,
              T* __restrict__ tile_sums) {
  using BlockScan = cub::BlockScan<T, kThreads>;
  __shared__ typename BlockScan::TempStorage temp;
  const long long base =
      (long long)blockIdx.x * kTile + (long long)threadIdx.x * kItems;
  T items[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + k;
    items[k] = i < n ? load(i) : T(0);
  }
  T agg;
  BlockScan(temp).InclusiveSum(items, items, agg);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + k;
    if (i < n) partial[i] = items[k];
  }
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = agg;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    scan_tile_sums(T* __restrict__ tile_sums, long long ntiles) {
  using BlockScan = cub::BlockScan<T, kThreads>;
  __shared__ typename BlockScan::TempStorage temp;
  __shared__ T carry;
  if (threadIdx.x == 0) carry = T(0);
  __syncthreads();
  for (long long base = 0; base < ntiles; base += kThreads) {
    const long long j = base + threadIdx.x;
    const T x = j < ntiles ? tile_sums[j] : T(0);
    T excl, agg;
    BlockScan(temp).ExclusiveSum(x, excl, agg);
    const T before = carry;
    if (j < ntiles) tile_sums[j] = excl + before;
    __syncthreads();
    if (threadIdx.x == 0) carry = before + agg;
    __syncthreads();
  }
  if (threadIdx.x == 0) tile_sums[ntiles] = carry;
}

// `partial` is not __restrict__: an epilogue may write its outputs over it.
template <typename T, typename Epi>
__global__ void add_pass(Epi epi, long long n, const T* partial,
                         const T* __restrict__ tile_sums, long long ntiles) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  epi(i, partial[i] + tile_sums[i / kTile], tile_sums[ntiles]);
}

// The three passes on `stream`; returns the first launch's cudaError_t.
template <typename T, typename Load, typename Epi>
int run(Load load, Epi epi, long long n, T* partial, T* tile_sums,
        cudaStream_t stream) {
  if (n <= 0) return 0;
  const long long ntiles = num_tiles(n);
  tile_scan<T, Load><<<(unsigned)ntiles, kThreads, 0, stream>>>(load, n, partial,
                                                                 tile_sums);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  scan_tile_sums<T><<<1, kThreads, 0, stream>>>(tile_sums, ntiles);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  add_pass<T, Epi><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      epi, n, partial, tile_sums, ntiles);
  return (int)cudaGetLastError();
}

}  // namespace scan
}  // namespace
