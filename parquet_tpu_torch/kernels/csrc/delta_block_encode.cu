// DELTA_BINARY_PACKED encode of one page of int32/int64 values: the block
// tables and the packed payload, for blocks of 128 deltas in 4 miniblocks
// of 32 (ops/delta.encode_delta's policy).
//
// Replaces parquet_tpu/kernels/device_ops.py:delta_block_encode_device
// (under XLA: a shifted subtract, reshape min and max, clz, a cumsum of
// payload sizes and a scatter-add of lo/hi word contributions over a padded
// bucket). Here the tables cover exactly the page's nb = ceil((n - 1) / 128)
// blocks. A tile is kG delta blocks (kTile deltas), one block of kThreads
// threads; a page is two launches, three past kGroup tiles:
//
//   front (both launches): warp w takes delta block tile * kG + w, lane l
//      its deltas 4l .. 4l + 3 (d = v[i+1] - v[i], wrapping, unsigned; the
//      values as 16-byte vectors where they are 16-byte aligned, the next
//      lane's first value by a shuffle). The block's signed minimum is a
//      warp reduction (INT_MAX stands in past the deltas); each group of 8
//      lanes (one miniblock) reduces max(d - min) (unsigned) to its width,
//      nbits - clz(max), and the adjusted deltas go to shared memory. A
//      miniblock of 32 values at width w is exactly w 32-bit words, so every
//      payload starts on a word.
//   1. tables: the front, writing mins and widths, and the tile's payload
//      words (the sum of its 4 kG widths).
//   1b. group_sums, past one group of kGroup tiles: each group's words.
//   2. pack: each block sums the earlier groups' words (kThreads a round)
//      and its group's earlier tiles' (one round), so the work stays linear
//      in the page where summing every earlier tile's words was quadratic;
//      it runs the front again (the values come from L2), scans its 4 kG widths
//      in one warp for the miniblocks' first words, and packs: thread t
//      takes the tile's words t, t + kThreads, ..., finds each word's
//      miniblock by a search of the 32 offsets and gathers the values whose
//      bits overlap it. No two threads write one word: no atomics.
//
// At a page (128-256 tiles) the two launches beat one launch with a
// decoupled look-back after a descriptor memset, and the five dependent
// launches (block tables, a three-pass scan of the miniblock payload
// sizes, the pack) this replaced (PERF.md §6).
//
// The words past the last payload are not written: the caller reads
// sum(widths) words. Pages of n <= 1 have no deltas and launch nothing.
//
// Bound on an H100: memory. Bytes: the values read once (4 or 8 B), the
// tables written (mins 4 or 8 B per 128 values, widths 4 B per 32) and the
// payload written once (width / 8 B per value). At a page the launches are
// the time.

#include "scan.cuh"

namespace {

constexpr int kBlock = 128;  // deltas a DELTA block
constexpr int kG = 8;        // delta blocks a tile, one a warp
constexpr int kThreads = 32 * kG;
constexpr int kTile = kG * kBlock;  // deltas a tile: device_ops.DELTA_ENCODE_TILE
constexpr int kGroup = kThreads;    // tiles a group: device_ops.DELTA_ENCODE_GROUP
static_assert(4 * kG == 32, "one warp scans the tile's miniblocks, one a lane");

template <typename S>
__device__ __forceinline__ S warp_min(S x) {
  for (int o = 16; o > 0; o >>= 1) {
    const S y = __shfl_xor_sync(0xFFFFFFFFu, x, o);
    x = y < x ? y : x;
  }
  return x;
}

__device__ __forceinline__ int bit_length(uint32_t x) { return x ? 32 - __clz((int)x) : 0; }
__device__ __forceinline__ int bit_length(unsigned long long x) {
  return x ? 64 - __clzll((long long)x) : 0;
}

// Values i .. i + 3 of v[0, n), 0 past n.
__device__ __forceinline__ void load4(const uint32_t* v, long long i, long long n, bool vec,
                                      uint32_t (&x)[4]) {
  if (vec && i + 4 <= n) {
    const uint4 q = *reinterpret_cast<const uint4*>(v + i);
    x[0] = q.x;
    x[1] = q.y;
    x[2] = q.z;
    x[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) x[k] = i + k < n ? v[i + k] : 0u;
  }
}

__device__ __forceinline__ void load4(const unsigned long long* v, long long i, long long n,
                                      bool vec, unsigned long long (&x)[4]) {
  if (vec && i + 4 <= n) {
    const ulonglong2 a = *reinterpret_cast<const ulonglong2*>(v + i);
    const ulonglong2 b = *reinterpret_cast<const ulonglong2*>(v + i + 2);
    x[0] = a.x;
    x[1] = a.y;
    x[2] = b.x;
    x[3] = b.y;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) x[k] = i + k < n ? v[i + k] : 0ull;
  }
}

// The tile's deltas: adjusted into adj (shared), widths into s_w (shared),
// mins and widths written when `write`.
template <typename U, typename S>
__device__ __forceinline__ void front(const U* __restrict__ v, long long n, bool vec, long long tile,
                                      S* __restrict__ mins, int32_t* __restrict__ widths,
                                      bool write, U* adj, int* s_w) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long nd = n - 1, nb = (nd + kBlock - 1) / kBlock;
  const long long blk = tile * kG + warp;
  const long long i0 = blk * kBlock + lane * 4;
  U x[4];
  load4(v, i0, n, vec, x);
  U next = __shfl_down_sync(0xFFFFFFFFu, x[0], 1);
  if (lane == 31) next = i0 + 4 < n ? v[i0 + 4] : U(0);
  U dl[4];
  S m = (S)(((U)~U(0)) >> 1);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    dl[e] = (U)((e < 3 ? x[e + 1] : next) - x[e]);
    if (i0 + e < nd) m = (S)dl[e] < m ? (S)dl[e] : m;
  }
  m = warp_min<S>(m);
  U mx = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const U a = i0 + e < nd ? (U)(dl[e] - (U)m) : U(0);
    adj[warp * kBlock + lane * 4 + e] = a;
    mx = a > mx ? a : mx;
  }
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) {
    const U y = __shfl_xor_sync(0xFFFFFFFFu, mx, o);
    mx = y > mx ? y : mx;
  }
  if ((lane & 7) == 0) {
    const int q = lane >> 3, w = bit_length(mx);
    s_w[warp * 4 + q] = w;
    if (write && blk < nb) widths[blk * 4 + q] = w;
  }
  if (write && lane == 0 && blk < nb) mins[blk] = m;
  __syncthreads();
}

// Launch 1: mins, widths and the tile's payload words.
template <typename U, typename S>
__global__ void __launch_bounds__(kThreads)
    tables(const U* __restrict__ v, long long n, bool vec, S* __restrict__ mins,
           int32_t* __restrict__ widths, unsigned int* __restrict__ tile_words) {
  __shared__ U adj[kTile];
  __shared__ int s_w[32];
  front<U, S>(v, n, vec, blockIdx.x, mins, widths, true, adj, s_w);
  if (threadIdx.x < 32) {
    int w = s_w[threadIdx.x];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) w += __shfl_xor_sync(0xFFFFFFFFu, w, o);
    if (threadIdx.x == 0) tile_words[blockIdx.x] = (unsigned int)w;
  }
}

// Launch 1b, past one group: the words of each group of kGroup tiles.
__global__ void __launch_bounds__(kThreads)
    group_sums(const unsigned int* __restrict__ tile_words, long long ntiles,
               unsigned int* __restrict__ group_words) {
  __shared__ unsigned int s_part[kThreads / 32];
  const long long j = (long long)blockIdx.x * kGroup + threadIdx.x;
  unsigned int x = j < ntiles ? tile_words[j] : 0u;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xFFFFFFFFu, x, o);
  if ((threadIdx.x & 31) == 0) s_part[threadIdx.x >> 5] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned int t = 0;
    for (int k = 0; k < kThreads / 32; ++k) t += s_part[k];
    group_words[blockIdx.x] = t;
  }
}

// Launch 2: the tile's first payload word, then its words.
template <typename U, typename S>
__global__ void __launch_bounds__(kThreads)
    pack(const U* __restrict__ v, long long n, bool vec, const unsigned int* __restrict__ tile_words,
         const unsigned int* __restrict__ group_words, uint32_t* __restrict__ words) {
  __shared__ U adj[kTile];
  __shared__ int s_w[32];
  __shared__ int s_off[32];
  __shared__ unsigned long long s_part[kThreads / 32];
  __shared__ int s_total;
  const long long tile = blockIdx.x;
  const long long group = tile / kGroup;
  // the words of the earlier groups and of the group's earlier tiles
  unsigned long long before = 0;
  for (long long j = threadIdx.x; j < group; j += kThreads) before += group_words[j];
  for (long long j = group * kGroup + threadIdx.x; j < tile; j += kThreads) before += tile_words[j];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) before += __shfl_xor_sync(0xFFFFFFFFu, before, o);
  if ((threadIdx.x & 31) == 0) s_part[threadIdx.x >> 5] = before;
  front<U, S>(v, n, vec, tile, nullptr, nullptr, false, adj, s_w);
  unsigned long long base = 0;
#pragma unroll
  for (int k = 0; k < kThreads / 32; ++k) base += s_part[k];
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int w = s_w[lane];
    int incl = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, incl, o);
      if (lane >= o) incl += y;
    }
    s_off[lane] = incl - w;
    if (lane == 31) s_total = incl;
  }
  __syncthreads();
  uint32_t* out = words + base;
  for (int j = threadIdx.x; j < s_total; j += kThreads) {
    // the last miniblock starting at or before word j holds it (a miniblock
    // of width 0 has no words)
    const int q = scan::count_le(s_off, 32, j) - 1;
    const int w = s_w[q];
    const int lo_bit = (j - s_off[q]) * 32;
    int k = lo_bit / w;
    int k_end = (lo_bit + 32 + w - 1) / w;
    if (k_end > 32) k_end = 32;
    const U* a = adj + q * 32;
    uint32_t word = 0;
    for (; k < k_end; ++k) {
      const unsigned long long y = (unsigned long long)a[k];
      const int b = k * w - lo_bit;  // in (-w, 32)
      word |= b >= 0 ? (uint32_t)(y << b) : (uint32_t)(y >> -b);
    }
    out[j] = word;
  }
}

inline bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

template <typename U, typename S>
int launch(const void* values, long long n, void* mins, void* widths, void* words,
           void* scratch, cudaStream_t s) {
  const long long nb = (n - 1 + kBlock - 1) / kBlock;
  const long long ntiles = (nb + kG - 1) / kG;
  const bool vec = aligned16(values);
  tables<U, S><<<(unsigned)ntiles, kThreads, 0, s>>>((const U*)values, n, vec, (S*)mins,
                                                    (int32_t*)widths, (unsigned int*)scratch);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  unsigned int* tile_words = (unsigned int*)scratch;
  unsigned int* group_words = tile_words + ntiles;
  if (ntiles > kGroup) {
    group_sums<<<(unsigned)((ntiles + kGroup - 1) / kGroup), kThreads, 0, s>>>(tile_words, ntiles,
                                                                               group_words);
    rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  pack<U, S><<<(unsigned)ntiles, kThreads, 0, s>>>((const U*)values, n, vec, tile_words,
                                                  group_words, (uint32_t*)words);
  return (int)cudaGetLastError();
}

}  // namespace

// values: n int32 (nbits 32) or int64 (nbits 64); with nb = ceil((n-1)/128)
// blocks: mins: nb of the values' type; widths: int32[4 nb]; words:
// uint32[4 nb nbits], room for the widest payload, the first sum(widths)
// written; scratch: uint32[t + ceil(t / kGroup)] for t = ceil(nb / kG)
// tiles (each tile's payload words, then each group's).
extern "C" int pqt_delta_block_encode(const void* values, long long n, int nbits, void* mins,
                                      void* widths, void* words, void* scratch, void* stream) {
  if (n <= 1) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (nbits == 32) return launch<uint32_t, int32_t>(values, n, mins, widths, words, scratch, s);
  if (nbits == 64)
    return launch<unsigned long long, long long>(values, n, mins, widths, words, scratch, s);
  return (int)cudaErrorInvalidValue;
}
