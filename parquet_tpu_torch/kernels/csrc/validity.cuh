// Counts of a row validity, the first launches of the two-launch scans over
// one (leaf_verdict.cu, expand_nullable.cu). The rows fall into tiles of
// kThreads x kItems; a thread's kItems consecutive validity bytes are read
// as 16-byte vectors (byte by byte where the validity is off 16 bytes or
// at its end):
//
//   counts: each tile's count of valid rows;
//   group_counts, past one group of kThreads tiles: each group's count.
//
// The caller's second launch takes a tile a block, sums the earlier
// groups' counts and its group's earlier tiles' (share_before, one round
// each, then block_sum) and places the tile's rows. No scratch of
// n rows and no look-back: at a row group (256 tiles) the two launches beat
// a descriptor memset and one launch with a decoupled look-back, and the
// group level keeps the sum linear past it (PERF.md §6). The scratch is
// uint32[t + ceil(t / kThreads)] for t tiles.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {
namespace validity {

constexpr int kVec = 16;  // rows a 16-byte vector of the validity

// 0x01 in each byte of x that is not zero, 0x00 elsewhere.
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t x) {
  return ((((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x) >> 7) & 0x01010101u;
}

inline bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

inline long long num_tiles(long long n, int tile) { return (n + tile - 1) / tile; }

// The validity bytes first .. first + kItems - 1 as 0x01 / 0x00 bytes (0
// past n), kVec a vector.
template <int kItems>
__device__ __forceinline__ void load_valid(const uint8_t* valid, long long first, long long n,
                                           bool vec, uint32_t (&w)[kItems / 4]) {
  static_assert(kItems % kVec == 0, "whole vectors a thread");
#pragma unroll
  for (int q = 0; q < kItems / kVec; ++q) {
    const long long f = first + q * kVec;
    if (vec && f + kVec <= n) {
      const uint4 x = *reinterpret_cast<const uint4*>(valid + f);
      w[4 * q] = nonzero_bytes(x.x);
      w[4 * q + 1] = nonzero_bytes(x.y);
      w[4 * q + 2] = nonzero_bytes(x.z);
      w[4 * q + 3] = nonzero_bytes(x.w);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) w[4 * q + k] = 0;
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        if (f + e < n && valid[f + e] != 0) w[4 * q + (e >> 2)] |= 1u << (8 * (e & 3));
    }
  }
}

// The number of 0x01 bytes in w.
template <int kItems>
__device__ __forceinline__ uint32_t count_bytes(const uint32_t (&w)[kItems / 4]) {
  uint32_t c = 0;
#pragma unroll
  for (int q = 0; q < kItems / 16; ++q)
    c += ((w[4 * q] + w[4 * q + 1] + w[4 * q + 2] + w[4 * q + 3]) * 0x01010101u) >> 24;
  return c;
}

// The block's sum of x (every thread calls it and gets the sum).
template <int kThreads>
__device__ __forceinline__ uint32_t block_sum(uint32_t x, uint32_t* s_part) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xFFFFFFFFu, x, o);
  if ((threadIdx.x & 31) == 0) s_part[threadIdx.x >> 5] = x;
  __syncthreads();
  uint32_t t = 0;
#pragma unroll
  for (int k = 0; k < kThreads / 32; ++k) t += s_part[k];
  return t;
}

// Launch 1: each tile's count of valid rows.
template <int kThreads, int kItems>
__global__ void __launch_bounds__(kThreads)
    counts(const uint8_t* __restrict__ valid, long long n, bool vec,
           uint32_t* __restrict__ tile_counts) {
  __shared__ uint32_t s_part[kThreads / 32];
  uint32_t w[kItems / 4];
  load_valid<kItems>(valid, ((long long)blockIdx.x * kThreads + threadIdx.x) * kItems, n, vec,
                     w);
  const uint32_t t = block_sum<kThreads>(count_bytes<kItems>(w), s_part);
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = t;
}

// Launch 1b, past one group: the count of each group of kThreads tiles.
template <int kThreads>
__global__ void __launch_bounds__(kThreads)
    group_counts(const uint32_t* __restrict__ tile_counts, long long ntiles,
                 uint32_t* __restrict__ groups) {
  __shared__ uint32_t s_part[kThreads / 32];
  const long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
  const uint32_t t = block_sum<kThreads>(j < ntiles ? tile_counts[j] : 0u, s_part);
  if (threadIdx.x == 0) groups[blockIdx.x] = t;
}

// This thread's share of the valid rows before `tile`, for a block of
// kBlock threads: the earlier groups' counts and its group's earlier
// tiles' (groups of kGroup tiles), a round of kBlock each when kBlock >=
// kGroup; their block_sum is the count.
template <int kBlock, int kGroup>
__device__ __forceinline__ uint32_t share_before(const uint32_t* __restrict__ tile_counts,
                                                 const uint32_t* __restrict__ groups,
                                                 long long tile) {
  const long long group = tile / kGroup;
  uint32_t b = 0;
  for (long long j = threadIdx.x; j < group; j += kBlock) b += groups[j];
  for (long long j = group * kGroup + threadIdx.x; j < tile; j += kBlock) b += tile_counts[j];
  return b;
}

// Launches 1 and, past one group, 1b on `stream`: `scratch` takes the
// ntiles tile counts, then the group counts. Returns the first failing
// launch's cudaError_t.
template <int kThreads, int kItems>
int count_tiles(const uint8_t* valid, long long n, long long ntiles, uint32_t* scratch,
                cudaStream_t stream) {
  counts<kThreads, kItems><<<(unsigned)ntiles, kThreads, 0, stream>>>(valid, n, aligned16(valid),
                                                                     scratch);
  int rc = (int)cudaGetLastError();
  if (rc || ntiles <= kThreads) return rc;
  group_counts<kThreads><<<(unsigned)num_tiles(ntiles, kThreads), kThreads, 0, stream>>>(
      scratch, ntiles, scratch + ntiles);
  return (int)cudaGetLastError();
}

}  // namespace validity
}  // namespace
