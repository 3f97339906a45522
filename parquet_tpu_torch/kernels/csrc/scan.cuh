// Device-wide prefix scans and searches.
//
// The one-pass inclusive scan over vectors (run1): a memset of the
// descriptors of the decoupled look-back below, then one launch whose
// blocks each take a tile of kBlock x kItems items (next_tile), load it a
// vector of kVec items at a time (a loader is `void operator()(long long
// first, T (&items)[kVec]) const`: the items first .. first + kVec - 1,
// zero past n), sum it with warp shuffles, look back for the earlier tiles'
// sum (seg_look_back) and hand each vector's inclusive sums and its items
// to the epilogue (`void operator()(long long first, const T (&incl)[kVec],
// const T (&items)[kVec]) const`, called for every vector, also past n),
// which may write them as one 16-byte store. No n-element scratch and no
// pass over the tile sums: at record_starts' 8 M entries it beat a
// two-launch scan (tile sums, then blocks that reduce them and scan their
// tile again) on an H100 (PERF.md §6). A launch after it on the same stream
// reads the grand total from the last tile's descriptor (run1_total).
//
// The one-pass vector scan (run1) is used by record_starts.cu,
// list_layout.cu and list_contains_mask.cu; the single-pass segmented scan
// below (seg_tile_scan) by delta_packed_decode.cu and, with no flag set,
// merge_mixed_bytes.cu and dict_indices.cu; the searches (count_le,
// warp_count_le2) by merge_mixed_bytes.cu, expand_hybrid.cu,
// expand_page_grid.cu, delta_packed_decode.cu and delta_block_encode.cu.
// (The two-launch scans over a row validity are validity.cuh's.) Sums are
// exact as long as they fit their type (the wrappers keep n below 2^31).
//
// Bound on an H100: memory. The scans write 16 bytes of descriptor a tile
// beyond their inputs and outputs, and no n-element scratch. 64-bit scans
// need the 256-thread cap of __launch_bounds__ (a 1,024-thread 64-bit
// BlockScan asked for more registers than an SM has).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <cub/block/block_scan.cuh>
#include <type_traits>

namespace {
namespace scan {

// ---------------------------------------------------------------------------
// Single-pass segmented scan across tiles (decoupled look-back), used by
// delta_packed_decode.cu and, with no flag set (a plain sum), by
// merge_mixed_bytes.cu and dict_indices.cu. Each block scans one tile of
// consecutive items in
// place:
//
//   SegPair<U> is (reset flag f, value v); SegOp restarts the sum at a set
//   flag, (fa, va) + (fb, vb) = (fa | fb, fb ? vb : va + vb), with U's
//   wrapping adds. An item with f set starts a segment with its own value.
//
// A block takes its tile index from next_tile (an atomicAdd on a counter),
// so every tile it may wait for has already started and never waits for it
// in turn. seg_tile_scan scans the block's items (cub::BlockScan with
// SegOp); the prefix callback, run by warp 0, publishes the tile's
// aggregate (status AGGREGATE, or PREFIX straight away when the tile holds
// a reset: its aggregate then needs nothing before it), then looks back
// over the earlier tiles' descriptors, 32 a step (one a lane), summing
// aggregates up to the nearest PREFIX, and publishes its own inclusive
// prefix. A tile whose first item starts a segment needs no carry and
// skips the look-back.
//
// A descriptor is one 16-byte word (status, value), stored and loaded as
// one 16-byte access (st/ld.relaxed.gpu.v2.u64, as CUB's single-pass scan
// keeps the descriptors of 8-byte values), so a status seen implies its
// value and no fence is needed. Weak .cg accesses are not enough: a look-back
// spinning on them read stale descriptors on an H100. The scratch is 64-bit words, [counter |
// pad | descriptors(2 t)] for t tiles (seg_scratch_words), all zeroed by
// the caller on the stream before each launch. Exact in any order:
// wrapping integer adds.

template <typename U>
struct SegPair {
  U v;
  uint32_t f;
};

template <typename U>
struct SegOp {
  __device__ __forceinline__ SegPair<U> operator()(const SegPair<U>& a,
                                                   const SegPair<U>& b) const {
    SegPair<U> r;
    r.f = a.f | b.f;
    r.v = b.f ? b.v : U(a.v + b.v);
    return r;
  }
};

inline long long seg_scratch_words(long long ntiles) { return 2 + 2 * ntiles; }

constexpr unsigned long long kSegNone = 0, kSegAggregate = 1, kSegPrefix = 2;

struct SegTiles {
  unsigned long long* words;
  long long ntiles;

  __device__ __forceinline__ void publish(long long tile, unsigned long long s,
                                          unsigned long long v) const {
    asm volatile("st.relaxed.gpu.global.v2.u64 [%0], {%1, %2};"
                 :: "l"(words + 2 + 2 * tile), "l"(s), "l"(v) : "memory");
  }
  __device__ __forceinline__ ulonglong2 read(long long tile) const {
    ulonglong2 r;
    asm volatile("ld.relaxed.gpu.global.v2.u64 {%0, %1}, [%2];"
                 : "=l"(r.x), "=l"(r.y) : "l"(words + 2 + 2 * tile) : "memory");
    return r;
  }
};

// The block's tile index, in the order blocks start. Every thread calls it.
__device__ __forceinline__ long long next_tile(const SegTiles& d,
                                               unsigned int* slot) {
  if (threadIdx.x == 0) *slot = atomicAdd((unsigned int*)d.words, 1u);
  __syncthreads();
  return (long long)*slot;
}

// The number of entries of the sorted a[0, n) that are <= x, by one thread
// (a binary search; `a` in shared or global memory).
template <typename T>
__device__ __forceinline__ int count_le(const T* a, int n, long long x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((long long)a[mid] <= x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The counts of entries of the sorted a[0, n) that are <= k0 and <= k1, by
// the 32 lanes of one warp (all of them call it; every lane gets the
// counts). Each round samples both open ranges at 32 evenly spaced entries,
// one a lane and key, and a ballot narrows each range to one sampling
// stride: ceil(log32(n)) rounds of dependent loads where a binary search
// takes log2(n). The first round's loads depend on n alone, so every block
// searching one table reads the same entries.
__device__ __forceinline__ int2 warp_count_le2(const int32_t* a, int n, long long k0,
                                               long long k1) {
  const int lane = threadIdx.x & 31;
  int lo[2] = {0, 0}, hi[2] = {n, n};
  const long long key[2] = {k0, k1};
  while (lo[0] < hi[0] || lo[1] < hi[1]) {
    int step[2];
    bool le[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      step[k] = (hi[k] - lo[k] + 31) / 32;
      const long long j = lo[k] + (long long)(lane + 1) * step[k] - 1;
      le[k] = step[k] > 0 && j < hi[k] && (long long)__ldg(a + j) <= key[k];
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (step[k] == 0) continue;
      // the samples at or below the key are a prefix of the lanes
      lo[k] += __popc(__ballot_sync(0xffffffffu, le[k])) * step[k];
      hi[k] = min(lo[k] + step[k] - 1, hi[k]);
    }
  }
  return make_int2(lo[0], lo[1]);
}

// The sum of everything before `tile` back to (and with) the nearest earlier
// tile's inclusive prefix. All 32 lanes of one warp call it, each reading one
// descriptor a step, nearest first. (Reading more a lane made each step wait
// for more tiles to publish, and was slower.)
template <typename U>
__device__ __forceinline__ U seg_look_back(const SegTiles& d, long long tile) {
  const int lane = threadIdx.x & 31;
  U run = U(0);
  for (long long top = tile - 1;; top -= 32) {
    const long long j = top - lane;
    ulonglong2 dsc = make_ulonglong2(kSegPrefix, 0ull);
    if (j >= 0) {
      do {
        dsc = d.read(j);
      } while (dsc.x == kSegNone);
    }
    const unsigned prefixes = __ballot_sync(0xffffffffu, dsc.x == kSegPrefix);
    const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
    U x = lane <= stop ? U(dsc.y) : U(0);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    run += x;
    if (prefixes) return run;
  }
}

template <typename U>
struct SegTilePrefix {
  SegTiles d;
  long long tile;
  bool first_resets;

  // called by warp 0 with the tile's aggregate; lane 0's return is the
  // tile's exclusive prefix
  __device__ __forceinline__ SegPair<U> operator()(const SegPair<U>& agg) {
    SegPair<U> prefix;
    prefix.v = U(0);
    prefix.f = 0;
    const bool lead = threadIdx.x == 0;
    if (tile == 0 || first_resets) {
      if (lead) d.publish(tile, kSegPrefix, (unsigned long long)agg.v);
      return prefix;
    }
    if (lead)
      d.publish(tile, agg.f ? kSegPrefix : kSegAggregate, (unsigned long long)agg.v);
    prefix.v = seg_look_back<U>(d, tile);
    if (lead && !agg.f)
      d.publish(tile, kSegPrefix, (unsigned long long)U(prefix.v + agg.v));
    return prefix;
  }
};

template <typename U, int kBlock>
using SegBlockScan = cub::BlockScan<SegPair<U>, kBlock, cub::BLOCK_SCAN_RAKING>;

// The inclusive segmented scan of the block's items in place, carried over
// from the earlier tiles. `first_resets`: the tile's first item has its flag
// set (the same in every thread).
template <typename U, int kBlock, int kItemsPerThread>
__device__ __forceinline__ void seg_tile_scan(
    typename SegBlockScan<U, kBlock>::TempStorage& temp,
    SegPair<U> (&items)[kItemsPerThread], const SegTiles& d, long long tile,
    bool first_resets) {
  SegTilePrefix<U> prefix{d, tile, first_resets};
  SegBlockScan<U, kBlock>(temp).InclusiveScan(items, items, SegOp<U>(), prefix);
}

// ---------------------------------------------------------------------------
// One-pass inclusive scan over vectors (run1; see the top of this file). A
// tile is kBlock x kItems items in warp-striped order: warp w takes the w-th
// run of 32 x kItems items, and its lane l the vectors l, l + 32, ... (kVec
// items each) of that run, so each vector access of a warp covers 32
// consecutive vectors. (A thread's kItems consecutive items, 64-128 bytes
// apart from its neighbours', ran at half the speed on an H100.)

template <int kBlock, int kItems, int kVec>
__device__ __forceinline__ long long vec_first(long long tile, int j) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return tile * (kBlock * kItems) + (long long)warp * (32 * kItems) +
         (long long)(j * 32 + lane) * kVec;
}

template <typename T, int kBlock, int kItems, int kVec, typename Load, typename Epi>
__global__ void __launch_bounds__(kBlock) vec_scan(Load load, Epi epi, SegTiles d) {
  using U = typename std::make_unsigned<T>::type;
  constexpr int kVecs = kItems / kVec, kWarps = kBlock / 32;
  __shared__ unsigned int slot;
  __shared__ U s_warp[kWarps];
  __shared__ U s_prefix;
  const long long tile = next_tile(d, &slot);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  T v[kVecs][kVec];
#pragma unroll
  for (int j = 0; j < kVecs; ++j) load(vec_first<kBlock, kItems, kVec>(tile, j), v[j]);
  // each vector's exclusive prefix in its warp's run: vectors in order
  // (j, lane), a warp scan a row
  U excl[kVecs];
  U run = U(0);
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    U s = U(0);
#pragma unroll
    for (int e = 0; e < kVec; ++e) s += U(v[j][e]);
    U x = s;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const U y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    excl[j] = run + x - s;
    run += __shfl_sync(0xffffffffu, x, 31);
  }
  if (lane == 0) s_warp[warp] = run;
  __syncthreads();
  U before = U(0), agg = U(0);
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) before += s_warp[w];
    agg += s_warp[w];
  }
  // warp 0 publishes the tile's sum and looks back for its prefix
  if (warp == 0) {
    U prefix = U(0);
    if (tile == 0) {
      if (lane == 0) d.publish(tile, kSegPrefix, (unsigned long long)agg);
    } else {
      if (lane == 0) d.publish(tile, kSegAggregate, (unsigned long long)agg);
      prefix = seg_look_back<U>(d, tile);
      if (lane == 0) d.publish(tile, kSegPrefix, (unsigned long long)U(prefix + agg));
    }
    if (lane == 0) s_prefix = prefix;
  }
  __syncthreads();
  const U prefix = s_prefix + before;
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    U acc = prefix + excl[j];
    T incl[kVec];
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      acc += U(v[j][e]);
      incl[e] = T(acc);
    }
    epi(vec_first<kBlock, kItems, kVec>(tile, j), incl, v[j]);
  }
}

// The descriptors' memset and the scan on `stream`; `descriptors` holds
// seg_scratch_words(run1_tiles<kBlock, kItems>(n)) words. Returns the first
// failing call's cudaError_t.
template <int kBlock, int kItems>
inline long long run1_tiles(long long n) {
  return (n + kBlock * kItems - 1) / (kBlock * kItems);
}

// The grand total of a finished run1 over ntiles >= 1 tiles (the last tile's
// inclusive prefix, as U's bits), for a launch after it on the same stream.
__device__ __forceinline__ unsigned long long run1_total(const unsigned long long* descriptors,
                                                         long long ntiles) {
  return descriptors[2 + 2 * (ntiles - 1) + 1];
}

template <typename T, int kBlock, int kItems, int kVec, typename Load, typename Epi>
int run1(Load load, Epi epi, long long n, unsigned long long* descriptors,
         cudaStream_t stream) {
  static_assert(kBlock % 32 == 0 && kItems % kVec == 0, "whole warps and vectors");
  if (n <= 0) return 0;
  const long long ntiles = run1_tiles<kBlock, kItems>(n);
  int rc = (int)cudaMemsetAsync(descriptors, 0,
                                (size_t)seg_scratch_words(ntiles) * sizeof(unsigned long long),
                                stream);
  if (rc) return rc;
  vec_scan<T, kBlock, kItems, kVec, Load, Epi><<<(unsigned)ntiles, kBlock, 0, stream>>>(
      load, epi, SegTiles{descriptors, ntiles});
  return (int)cudaGetLastError();
}

}  // namespace scan
}  // namespace
