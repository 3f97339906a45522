// Null expansion: the dense non-null values of a nullable column scattered
// into row positions, nulls zero-filled.
//
// Replaces the jitted inner `expand` of parquet_tpu/core/reader.py:
// _expand_nullable_device (under XLA: a cumsum of the validity mask, a
// clipped gather and a select):
//
//   out[i] = mask[i] ? values[clip(inclusive_count(mask)[i] - 1, 0, nv - 1)] : 0
//
// and all zeros when nv == 0. Elements are copied by byte width (1, 4 or 8
// bytes), so bool, integer and float columns share one kernel and a float
// zero is the bit pattern 0.
//
// Two launches over tiles of kThreads x kItems rows, no scratch of n rows:
//
//   1. counts (validity.cuh): each tile's count of valid rows, the mask read
//      as 16-byte vectors; 1b. group_counts past one group of kGroup tiles;
//   2. place: each block sums the earlier groups' and tiles' counts in one
//      round and writes its tile, kPlaceItems rows a thread (16 for 1-byte
//      values). A 16-byte vector of `out` holds kRows = 16 / E rows, and
//      lane l of warp w takes the vectors j * 32 + l of the warp's rows, so
//      each store of a warp covers 32 consecutive vectors. A warp scan over
//      each row of vectors and the warps' totals give every vector its
//      dense start; the
//      dense indices of consecutive valid rows are consecutive, so the lanes
//      of a warp read neighbouring spans of `values` (L1 hits after the
//      first), and each vector goes out as one 16-byte store (row by row at
//      the end of the rows or where `out` is off 16 bytes).
//
// Bound on an H100: memory. Bytes: the mask read once (1 B per row), the
// non-null values read once (E B each) and the output written once (E B
// per row); launch 2 reads the mask again (from L2). The three-pass scan
// it replaced wrote and read an int32 partial (8 B more per row) in three
// launches; at a row group (2^20 rows) the launches are most of the time.

#include "validity.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;  // rows a thread; kThreads * kItems: device_ops.EXPAND_NULLABLE_TILE
constexpr int kGroup = kThreads;  // tiles a group: device_ops.EXPAND_NULLABLE_GROUP
static_assert(kGroup == kThreads, "validity.cuh groups kThreads tiles");
constexpr int kTile = kThreads * kItems;
// rows a thread of the placement (at least a 16-byte vector's): fewer rows
// a thread, more threads a tile, more loads in flight an SM
constexpr int kPlaceItems = 8;

// Bit e: row first + e of the mask is set (none at or past n). `vec`: the
// kRows bytes may be read as one access (aligned to kRows).
template <int kRows>
__device__ __forceinline__ uint32_t mask_bits(const uint8_t* mask, long long first, long long n,
                                              bool vec) {
  if (vec && first + kRows <= n) {
    if constexpr (kRows == 16) {
      const uint4 x = *reinterpret_cast<const uint4*>(mask + first);
      const uint32_t w[4] = {x.x, x.y, x.z, x.w};
      uint32_t b = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q)  // 0x01 bytes to 4 bits (the products do not carry)
        b |= ((validity::nonzero_bytes(w[q]) * 0x01020408u) >> 24) << (4 * q);
      return b;
    } else if constexpr (kRows == 4) {
      return (validity::nonzero_bytes(*reinterpret_cast<const uint32_t*>(mask + first)) *
              0x01020408u) >> 24;
    } else {
      const uint32_t x = *reinterpret_cast<const uint16_t*>(mask + first);
      return (x & 0xFFu ? 1u : 0u) | (x >> 8 ? 2u : 0u);
    }
  }
  uint32_t b = 0;
#pragma unroll
  for (int e = 0; e < kRows; ++e)
    if (first + e < n && mask[first + e] != 0) b |= 1u << e;
  return b;
}

// Rows first .. first + kRows - 1 of `out` (one 16-byte store where
// aligned), none at or past n.
template <typename E, int kRows>
__device__ __forceinline__ void store_rows(E* out, long long first, long long n, bool vec,
                                           const E (&v)[kRows]) {
  if (vec && first + kRows <= n) {
    uint4 q;
    if constexpr (sizeof(E) == 1) {
      uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
      for (int e = 0; e < 16; ++e) w[e >> 2] |= (uint32_t)v[e] << (8 * (e & 3));
      q = make_uint4(w[0], w[1], w[2], w[3]);
    } else if constexpr (sizeof(E) == 4) {
      q = make_uint4(v[0], v[1], v[2], v[3]);
    } else {
      q = make_uint4((uint32_t)v[0], (uint32_t)(v[0] >> 32), (uint32_t)v[1],
                     (uint32_t)(v[1] >> 32));
    }
    *reinterpret_cast<uint4*>(out + first) = q;
  } else {
#pragma unroll
    for (int e = 0; e < kRows; ++e)
      if (first + e < n) out[first + e] = v[e];
  }
}

template <typename E>
struct Place {
  static constexpr int kRows = 16 / sizeof(E);  // rows a 16-byte vector of out
  static constexpr int kItems = kPlaceItems > kRows ? kPlaceItems : kRows;  // rows a thread
  static constexpr int kBlock = kTile / kItems;  // threads a tile
  static constexpr int kVecs = kItems / kRows;   // vectors a thread
  static_assert(kItems % kRows == 0 && kTile % kItems == 0, "whole vectors a thread");
};

// Launch 2: the tile's rows.
template <typename E>
__global__ void __launch_bounds__(Place<E>::kBlock)
    place(const E* __restrict__ values, long long nv, const uint8_t* __restrict__ mask,
          long long n, bool mvec, const uint32_t* __restrict__ tile_counts,
          const uint32_t* __restrict__ groups, bool ovec, E* __restrict__ out) {
  constexpr int kRows = Place<E>::kRows, kItems = Place<E>::kItems;
  constexpr int kBlock = Place<E>::kBlock, kVecs = Place<E>::kVecs;
  __shared__ uint32_t s_part[kBlock / 32];
  __shared__ uint32_t s_warp[kBlock / 32];
  const long long tile = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t share = validity::share_before<kBlock, kGroup>(tile_counts, groups, tile);
  const long long base = tile * kTile + (long long)warp * (32 * kItems);
  uint32_t bits[kVecs], excl[kVecs];
  uint32_t run = 0;  // the warp's valid rows before vector row j
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    bits[j] = mask_bits<kRows>(mask, base + (long long)(j * 32 + lane) * kRows, n, mvec);
    const uint32_t c = __popc(bits[j]);
    uint32_t x = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, x, o);
      if (lane >= o) x += y;
    }
    excl[j] = run + x - c;
    run += __shfl_sync(0xFFFFFFFFu, x, 31);
  }
  if (lane == 0) s_warp[warp] = run;
  // the rows before the warp's: earlier tiles, then earlier warps
  uint32_t before = validity::block_sum<kBlock>(share, s_part);
#pragma unroll
  for (int k = 0; k < kBlock / 32; ++k)
    if (k < warp) before += s_warp[k];
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const long long f = base + (long long)(j * 32 + lane) * kRows;
    if (f >= n) return;
    long long k = (long long)before + excl[j];  // the dense index of the vector's first valid row
    E v[kRows];
#pragma unroll
    for (int e = 0; e < kRows; ++e) {
      v[e] = E(0);
      if ((bits[j] >> e) & 1u) {
        if (nv > 0) v[e] = values[k < nv ? k : nv - 1];
        ++k;
      }
    }
    store_rows<E, kRows>(out, f, n, ovec, v);
  }
}

template <typename E>
int launch(const void* values, long long nv, const void* mask, long long n, void* out,
           void* scratch, cudaStream_t s) {
  const long long ntiles = validity::num_tiles(n, kTile);
  const uint8_t* m = (const uint8_t*)mask;
  uint32_t* tile_counts = (uint32_t*)scratch;
  const int rc = validity::count_tiles<kThreads, kItems>(m, n, ntiles, tile_counts, s);
  if (rc) return rc;
  place<E><<<(unsigned)ntiles, Place<E>::kBlock, 0, s>>>(
      (const E*)values, nv, m, n, (uintptr_t)mask % Place<E>::kRows == 0, tile_counts,
      tile_counts + ntiles, validity::aligned16(out), (E*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// values: nv elements of elem_bytes (1, 4 or 8); mask: uint8[n]; out: n
// elements of elem_bytes; scratch: uint32[t + ceil(t / kGroup)] for t =
// ceil(n / (kThreads * kItems)) tiles (each tile's count of valid rows, then
// each group's).
extern "C" int pqt_expand_nullable(const void* values, long long nv, int elem_bytes,
                                   const void* mask, long long n, void* out, void* scratch,
                                   void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (elem_bytes) {
    case 1:
      return launch<uint8_t>(values, nv, mask, n, out, scratch, s);
    case 4:
      return launch<uint32_t>(values, nv, mask, n, out, scratch, s);
    case 8:
      return launch<unsigned long long>(values, nv, mask, n, out, scratch, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
