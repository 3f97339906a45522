// The RLE/bit-packed hybrid encode's device half: which values go into RLE
// runs, and the rest compacted in order and bit-packed.
//
// Replaces parquet_tpu/kernels/device_ops.py:rle_hybrid_encode_device (under
// XLA: a boundary compare, cumsum, segment scatter-min/max of run extents,
// the 8-aligned window arithmetic, a cumsum and scatter-max compaction, then
// bitpack_encode_device). Its policy is ops/rle_hybrid.encode_hybrid's: a run
// of equal values [s, e) yields the RLE window [(s + 7) & ~7, e & ~7) when
// the run has >= 8 values and the window >= 8; every other value is
// bit-packed, and rle_break marks each window's first value (adjacent
// windows of different runs stay apart).
//
// Two launches over tiles of kTile consecutive values (a thread holds kItems
// of them), a third between them on pages of more than kGroup tiles, with
// no scratch of n elements and no chain between tiles. A boundary is a
// position i with i == 0 or v[i] != v[i-1]; position n counts as one. In
// each tile, a prefix max of the boundaries gives each value the start of
// its run, and a suffix min of the boundaries after it (the one at the
// tile's end included, read from the next value) its end, where they lie
// in the tile.
//
//   1. tile_plans: each tile writes a record (first boundary, last boundary,
//      kept values): the kept count covers the runs that start and end in
//      the tile. A tile with no boundary lies inside one run. The blocks
//      also zero the packed output, grid-stride, for the atomics of 2.
//   1b. group_plans, when there is more than one group of kGroup tiles:
//      each group's record of the same three, from its tiles' records by
//      the walk below (a boundary at the group's end closes a run in it).
//   2. place: each block loads and scans its own tile, then walks the
//      records (last first, kThreads a step): the group records, then the
//      tile records of its own group (one step). The walk gives each record
//      u the end of the run that starts at its last boundary (the nearest
//      later first boundary) and, when that run runs past u, adds its kept
//      values in closed form (a run keeps its length minus its window).
//      Summed over the records before the tile, less the part of the run
//      over its first value that lies at or after it, that gives the block
//      its compaction offset; summed over all of them, n_bp. The records
//      also give the start of the run over the tile's first value (the
//      largest earlier boundary) and the end of the run over its last (the
//      smallest later one). The block then finds each value's run, writes
//      in_rle and rle_break, stages its kept values in shared memory at
//      their compacted positions less its offset, and writes the packed
//      words over bits [offset * width, (offset + kept) * width) with
//      bitpack.cuh (bitpack_encode's layout): whole words as stores, the
//      first and last, which it may share with the blocks of the tiles
//      before and after, with atomicOr. The block of the last tile writes
//      n_bp. A block walks ceil(groups / kThreads) + 1 steps, not one a
//      kThreads tiles: a walk over every tile record made the plan
//      quadratic in the page (17 steps a block at 2^22 values ran slower
//      than the three-pass scans).
//
// Packing in place saves the bitpack_encode launch that packed an n-value
// scratch, which place wrote and zeroed past n_bp (8 B a value of traffic
// and a third device operation at a page).
//
// Bound on an H100: memory. Bytes: the values read (4 B), the two masks
// written (2 B) and the bit-packed groups written. The kernel reads the
// values twice (the second time from L2), writes the packed words twice
// (zeros, then the words) and 16 B of record a tile. At a page's 262,144
// values the launches are the time: 1,024-value tiles (256 blocks) beat
// 512 and 2,048 on an H100 (PERF.md §6).

#include <climits>
#include <cstdint>
#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>
#include <cuda_runtime.h>

#include "bitpack.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;  // device_ops.RLE_PLAN_TILE
constexpr int kGroup = kThreads;           // tiles a group: device_ops.RLE_PLAN_GROUP
constexpr int kWarps = kThreads / 32;
static_assert(kItems % 4 == 0, "16-byte value loads, 4-byte mask stores");

struct MaxOp {
  __device__ __forceinline__ int operator()(int a, int b) const { return a > b ? a : b; }
};

struct MinOp {
  __device__ __forceinline__ int operator()(int a, int b) const { return a < b ? a : b; }
};

// The RLE window's kept values of a run [s, e) within [x, y) (a part of it).
__device__ __forceinline__ int kept_in(long long s, long long e, long long x, long long y) {
  const long long rs = (s + 7) & ~7LL, re = e & ~7LL;
  long long k = y - x;
  if (e - s >= 8 && re - rs >= 8) {
    const long long lo = x > rs ? x : rs, hi = y < re ? y : re;
    if (hi > lo) k -= hi - lo;
  }
  return (int)k;
}

__device__ __forceinline__ bool in_window(long long s, long long e, long long i) {
  const long long rs = (s + 7) & ~7LL, re = e & ~7LL;
  return e - s >= 8 && re - rs >= 8 && i >= rs && i < re;
}

// Inclusive suffix min of h over the block (h[k] at position threadIdx.x *
// kN + k); returns the block's min. `warp_min`: kWarps ints of shared memory,
// free on entry.
template <int kN>
__device__ __forceinline__ int block_suffix_min(int (&h)[kN], int* warp_min) {
#pragma unroll
  for (int k = kN - 2; k >= 0; --k) h[k] = min(h[k], h[k + 1]);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int in = h[0];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_down_sync(0xffffffffu, in, o);
    if (lane + o < 32) in = min(in, y);
  }
  if (lane == 0) warp_min[warp] = in;
  __syncthreads();
  int after = INT_MAX, all = INT_MAX;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int x = warp_min[w];
    all = min(all, x);
    if (w > warp) after = min(after, x);
  }
  int next = __shfl_down_sync(0xffffffffu, in, 1);
  if (lane == 31) next = INT_MAX;
  const int excl = min(next, after);
#pragma unroll
  for (int k = 0; k < kN; ++k) h[k] = min(h[k], excl);
  return all;
}

// A walk's sums over records [lo, hi) as seen from record t.
struct Acc {
  int before;  // kept values of the runs that start in records before t
  int total;   // kept values of the runs that start in any of them
  int s_head;  // the largest boundary in records before t
  int first;   // the smallest boundary in any of them
};

struct AccOp {
  __device__ __forceinline__ Acc operator()(const Acc& a, const Acc& b) const {
    return {a.before + b.before, a.total + b.total, max(a.s_head, b.s_head),
            min(a.first, b.first)};
  }
};

struct Shared {
  union {
    cub::BlockScan<int, kThreads>::TempStorage scan;
    cub::BlockReduce<int, kThreads>::TempStorage reduce[3];
    cub::BlockReduce<Acc, kThreads>::TempStorage reduce_acc;
  } temp;
  int warp_min[kWarps];
  Acc acc;
  int later;
};

// One tile's values and, for each, the start of its run where it lies in
// the tile (else -1) and its end where it lies in (p, tile end] (else
// INT_MAX). p0 = the thread's first position.
struct TileRuns {
  uint32_t x[kItems];
  int s[kItems];
  int e[kItems];
};

__device__ __forceinline__ void tile_runs(const uint32_t* __restrict__ v, long long n,
                                          long long p0, bool vec, TileRuns& r, Shared& sh) {
  if (vec && p0 + kItems <= n) {
#pragma unroll
    for (int k = 0; k < kItems; k += 4) {
      const uint4 q = *reinterpret_cast<const uint4*>(v + p0 + k);
      r.x[k] = q.x;
      r.x[k + 1] = q.y;
      r.x[k + 2] = q.z;
      r.x[k + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) r.x[k] = p0 + k < n ? v[p0 + k] : 0u;
  }
  const uint32_t prev = p0 > 0 && p0 <= n ? v[p0 - 1] : 0u;
  const uint32_t next = p0 + kItems < n ? v[p0 + kItems] : 0u;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long p = p0 + k;
    const bool at = p < n && (p == 0 || r.x[k] != (k ? r.x[k - 1] : prev));
    // the next position is a boundary (position n is one)
    const bool after =
        p < n && (p + 1 >= n || (k + 1 < kItems ? r.x[k + 1] : next) != r.x[k]);
    r.s[k] = at ? (int)p : -1;
    r.e[k] = after ? (int)(p + 1) : INT_MAX;
  }
  cub::BlockScan<int, kThreads>(sh.temp.scan).InclusiveScan(r.s, r.s, MaxOp());
  block_suffix_min<kItems>(r.e, sh.warp_min);
  __syncthreads();  // sh free again
}

__device__ __forceinline__ bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

// Launch 1: each tile's (first boundary or INT_MAX, last boundary or -1,
// kept values of the runs inside it); `packed` (n_words, 16-byte aligned)
// zeroed.
__global__ void __launch_bounds__(kThreads)
    tile_plans(const uint32_t* __restrict__ v, long long n, int4* __restrict__ recs,
               uint32_t* __restrict__ packed, long long n_words) {
  __shared__ Shared sh;
  // a memset in its own operation cost 0.0010 ms more at a page (PERF.md §6)
  const long long stride = (long long)gridDim.x * kThreads;
  const long long t0 = (long long)blockIdx.x * kThreads + threadIdx.x;
  for (long long q = t0; q < n_words / 4; q += stride)
    reinterpret_cast<uint4*>(packed)[q] = make_uint4(0u, 0u, 0u, 0u);
  if (t0 < n_words % 4) packed[n_words / 4 * 4 + t0] = 0u;
  const long long p0 = (long long)blockIdx.x * kTile + (long long)threadIdx.x * kItems;
  TileRuns r;
  tile_runs(v, n, p0, aligned16(v), r, sh);
  int kept = 0, first = INT_MAX, last = -1;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long p = p0 + k;
    if (p >= n) continue;
    if (r.s[k] == (int)p) {
      first = min(first, (int)p);
      last = max(last, (int)p);
    }
    if (r.s[k] >= 0 && r.e[k] != INT_MAX && !in_window(r.s[k], r.e[k], p)) ++kept;
  }
  kept = cub::BlockReduce<int, kThreads>(sh.temp.reduce[0]).Sum(kept);
  first = cub::BlockReduce<int, kThreads>(sh.temp.reduce[1]).Reduce(first, MinOp());
  last = cub::BlockReduce<int, kThreads>(sh.temp.reduce[2]).Reduce(last, MaxOp());
  if (threadIdx.x == 0) recs[blockIdx.x] = make_int4(first, last, kept, 0);
}

// Walks records recs[lo, hi) (record u covers positions [u * unit,
// min((u + 1) * unit, n))), the last kThreads first, and returns the
// block's Acc as seen from record t. A record's kept values are those of
// the runs that start in it: its own count (runs that start and end in it)
// and, when the run from its last boundary runs past its end, that run's
// in closed form, up to the first later boundary: the min of the later
// records' first boundaries, or `carry` past hi (INT_MAX: none, so the run
// is not counted). *later: the first boundary at or after record t's end.
__device__ __forceinline__ Acc walk(const int4* __restrict__ recs, long long lo, long long hi,
                                    long long t, int carry, long long unit, long long n,
                                    Shared& sh, int* later_t) {
  long long base = lo + (hi - 1 - lo) / kThreads * kThreads;
  Acc acc{0, 0, -1, INT_MAX};
  for (; base >= lo; base -= kThreads) {
    const long long u = base + threadIdx.x;
    const int4 rec = u < hi ? recs[u] : make_int4(INT_MAX, -1, 0, 0);
    // g: the min first boundary of records u + 1 .. base + kThreads, once scanned
    int g[1] = {u + 1 < hi ? recs[u + 1].x : INT_MAX};
    const int round_min = block_suffix_min<1>(g, sh.warp_min);
    const int later = min(g[0], carry);
    __syncthreads();  // warp_min read
    if (u < hi) {
      int c = rec.z;
      // the run from the last boundary runs past the record
      if (rec.y >= 0 && later != INT_MAX && later > min((u + 1) * unit, n))
        c += kept_in(rec.y, later, rec.y, later);
      acc.total += c;
      acc.first = min(acc.first, rec.x);
      if (u < t) {
        acc.before += c;
        acc.s_head = max(acc.s_head, rec.y);
      }
      if (u == t) sh.later = later;
    }
    carry = min(carry, round_min);
  }
  acc = cub::BlockReduce<Acc, kThreads>(sh.temp.reduce_acc).Reduce(acc, AccOp());
  if (threadIdx.x == 0) sh.acc = acc;
  __syncthreads();
  acc = sh.acc;
  *later_t = sh.later;
  __syncthreads();  // sh free again
  return acc;
}

// Launch 1b, when there is more than one group of kGroup tiles: each group's
// record (first boundary, last boundary, kept values of the runs that start
// and end in it), from its tiles' records.
__global__ void __launch_bounds__(kThreads)
    group_plans(const int4* __restrict__ recs, long long ntiles, long long n,
                int4* __restrict__ groups) {
  __shared__ Shared sh;
  const long long lo = (long long)blockIdx.x * kGroup;
  const long long hi = min(lo + kGroup, ntiles);
  // a boundary at the group's end (position n is one) ends a run in it
  const int at_end =
      hi == ntiles ? (int)n : (recs[hi].x == (int)(hi * kTile) ? (int)(hi * kTile) : INT_MAX);
  int later;
  const Acc acc = walk(recs, lo, hi, hi, at_end, kTile, n, sh, &later);
  if (threadIdx.x == 0) groups[blockIdx.x] = make_int4(acc.first, acc.s_head, acc.total, 0);
}

// Launch 2. `groups`: the group records when ngroups > 1.
__global__ void __launch_bounds__(kThreads)
    place(const uint32_t* __restrict__ v, long long n, int width, const int4* __restrict__ recs,
          long long ntiles, const int4* __restrict__ groups, long long ngroups,
          bool* __restrict__ in_rle, bool* __restrict__ rle_break,
          uint32_t* __restrict__ packed, int32_t* __restrict__ n_bp) {
  __shared__ Shared sh;
  __shared__ uint32_t staged[bitpack::slots(kTile)];
  const long long t = blockIdx.x;
  const long long a = t * kTile;
  const long long p0 = a + (long long)threadIdx.x * kItems;
  TileRuns r;
  tile_runs(v, n, p0, aligned16(v), r, sh);
  const int4 own = recs[t];
  // the groups before this tile's and after it, then the tiles of its group
  // (one round): the tile's kept values before it, the largest boundary
  // before it, the first boundary at or after its end and n_bp
  const long long grp = t / kGroup;
  Acc head{0, 0, -1, INT_MAX};
  int carry = (int)n;
  if (ngroups > 1) head = walk(groups, 0, ngroups, grp, (int)n, (long long)kTile * kGroup, n,
                               sh, &carry);
  int e_tail;
  const Acc acc = walk(recs, grp * kGroup, min(grp * kGroup + kGroup, ntiles), t, carry, kTile,
                       n, sh, &e_tail);
  const int total = ngroups > 1 ? head.total : acc.total;
  const int s_head = max(head.s_head, acc.s_head);
  int offset = head.before + acc.before;
  // the run over the tile's first value began before it: its kept values at
  // and after the tile's start belong to this tile and the later ones
  if (t > 0 && own.x != (int)a) {
    const int e_head = own.x != INT_MAX ? own.x : e_tail;
    offset -= kept_in(s_head, e_head, a, e_head);
  }

  bool keep[kItems];
  int pos[kItems];
  union {
    uint32_t w[kItems / 4];
    bool b[kItems];
  } rle, brk;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long p = p0 + k;
    const long long s = r.s[k] >= 0 ? r.s[k] : s_head;
    const long long e = r.e[k] != INT_MAX ? r.e[k] : e_tail;
    const bool w = p < n && in_window(s, e, p);
    rle.b[k] = w;
    brk.b[k] = w && p == ((s + 7) & ~7LL);
    keep[k] = p < n && !w;
    pos[k] = keep[k];
  }
  int kept;
  cub::BlockScan<int, kThreads>(sh.temp.scan).ExclusiveSum(pos, pos, kept);
  if (p0 + kItems <= n) {
#pragma unroll
    for (int k = 0; k < kItems / 4; ++k) {
      reinterpret_cast<uint32_t*>(in_rle + p0)[k] = rle.w[k];
      reinterpret_cast<uint32_t*>(rle_break + p0)[k] = brk.w[k];
    }
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (p0 + k < n) {
        in_rle[p0 + k] = rle.b[k];
        rle_break[p0 + k] = brk.b[k];
      }
    }
  }
  const uint32_t mask = bitpack::mask_of(width);
#pragma unroll
  for (int k = 0; k < kItems; ++k)
    if (keep[k]) staged[bitpack::slot(pos[k])] = r.x[k] & mask;
  __syncthreads();
  // the last kept values of the page own the bits past them
  bitpack::store_span(staged, kept, width, (long long)offset * width, false,
                      offset + kept == total, packed, threadIdx.x, kThreads);
  if (threadIdx.x == 0 && a + kTile >= n) *n_bp = total;
}

}  // namespace

// values: uint32[n] (< 2^width); in_rle, rle_break: bool[n], 4-byte
// aligned; packed: uint32[n_words], 16-byte aligned, n_words =
// ceil(n * width / 32) + 1 (bitpack_encode's layout over n values: the
// words past n_bp's and the guard word zero); n_bp: int32[1]; tiles:
// int32[4 * (ntiles + ngroups)], the tiles' records, then the groups'
// (ntiles = ceil(n / kTile), ngroups = ceil(ntiles / kGroup)).
extern "C" int pqt_rle_hybrid_encode(const void* values, long long n, int width, void* in_rle,
                                     void* rle_break, void* packed, long long n_words,
                                     void* n_bp, void* tiles, void* stream) {
  if (n <= 0) return 0;
  if ((uintptr_t)in_rle % 4 != 0 || (uintptr_t)rle_break % 4 != 0 ||
      (uintptr_t)packed % 16 != 0 || width < 0 || width > 32 ||
      n_words != (n * width + 31) / 32 + 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const long long ntiles = (n + kTile - 1) / kTile;
  const uint32_t* v = (const uint32_t*)values;
  const long long ngroups = (ntiles + kGroup - 1) / kGroup;
  int4* recs = (int4*)tiles;
  tile_plans<<<(unsigned)ntiles, kThreads, 0, s>>>(v, n, recs, (uint32_t*)packed, n_words);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  if (ngroups > 1) {
    group_plans<<<(unsigned)ngroups, kThreads, 0, s>>>(recs, ntiles, n, recs + ntiles);
    rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  place<<<(unsigned)ntiles, kThreads, 0, s>>>(v, n, width, recs, ntiles, recs + ntiles, ngroups,
                                              (bool*)in_rle, (bool*)rle_break,
                                              (uint32_t*)packed, (int32_t*)n_bp);
  return (int)cudaGetLastError();
}
