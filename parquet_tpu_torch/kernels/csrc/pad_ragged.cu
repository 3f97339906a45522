// Ragged rows padded to a fixed width: a flat element vector and per-row
// lengths into a [rows, max_len] matrix.
//
// Replaces the jitted inner `pad` of parquet_tpu/core/reader.py:
// _pad_ragged_device (under XLA: a cumsum of the lengths, a [rows, max_len]
// index matrix, a clipped gather and a select). The lengths are int32 or
// int64 (the reference's host reduceat gives either); with offs the
// exclusive scan of the lengths cast to int32 (wrapping as the reference's
// int32 cumsum does):
//
//   out[r, j] = j < lengths[r] ? values[clip(offs[r] + j, 0, nv - 1)] : 0
//
// and all zeros when nv == 0. Elements are copied by byte width (1, 4 or 8
// bytes), so bool, integer and float columns share one kernel and a float
// zero is the bit pattern 0.
//
// Two kernels over tiles of consecutive rows (a multiple of 16 rows, at
// most kTileRows, fewer when rows are wide so that a tile's output stays
// near kTileBytes), so a tile's output block is one contiguous, 16-byte
// aligned range:
//
//   1. tile_sums: each block the wrapping int32 sum of its tile's lengths;
//   2. pad: each block reduces the sums of the tiles before its own (its
//      prefix: no chain between tiles), loads its tile's lengths once,
//      scans them as wrapping int32 and keeps each row's offset and its
//      limit min(max(len, 0), max_len) (the compare j < len in the
//      length's own type) in shared memory. Then, output-stationary, each
//      thread assembles aligned 16-byte chunks of the tile's output block
//      and stores each as one 16-byte store. A chunk's first (row, j) comes
//      from a 32-bit division by max_len through a precomputed reciprocal
//      (no 64-bit division per slot); the row may change inside a chunk.
//      Each slot reads values[clip(int32(offs[r] + j), 0, nv - 1)] from
//      global memory. The output's last chunk, when the matrix is not a
//      multiple of 16 bytes, is stored element by element.
//
// Bound on an H100: memory. Bytes: lengths read once (4 or 8 B per row), the
// elements read once (E B each) and the padded matrix written once
// (rows x max_len x E). Beyond them: the lengths read a second time (from
// L2) and 4 bytes of tile sum a tile; no scratch of `rows` elements. At the
// sessions batch's shape this takes 0.046 ms against a 0.032 ms bound on an
// H100 80GB HBM3 at 700 W (PERF.md §6, PR 9). Why two launches: a
// single-pass scan with decoupled look-back waited 0.018 ms on its chain
// there; and why no staging: copying a tile's source span into shared
// memory first lost to these direct reads in every A/B.

#include <climits>
#include <cstdint>
#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 2;
constexpr int kTileRows = kThreads * kItems;  // device_ops.PAD_RAGGED_TILE
constexpr int kTileBytes = 32768;  // output bytes a tile of wide rows aims at
static_assert(kTileRows % 16 == 0, "16-byte aligned tiles");

using U = uint32_t;

struct Args {
  const uint8_t* values;
  long long nv;
  const void* lengths;
  long long rows;
  int max_len;
  int tile_rows;
  uint32_t div_mul;  // q / max_len = __umulhi(q, div_mul) >> div_shift, q < 2^31
  int div_shift;
  uint8_t* out;
};

// Rows a tile takes: kTileRows, or fewer (a multiple of 16, at least 16)
// when a row's output is wide.
inline int tile_rows_for(int max_len, int elem_bytes) {
  const long long row_bytes = (long long)max_len * elem_bytes;
  long long t = row_bytes > 0 ? kTileBytes / row_bytes : kTileRows;
  t = t / 16 * 16;
  return (int)(t < 16 ? 16 : (t > kTileRows ? kTileRows : t));
}

// Each block the wrapping int32 sum of one tile's lengths.
template <typename L>
__global__ void __launch_bounds__(kThreads)
    tile_sums(const L* __restrict__ lengths, long long rows, int tile_rows,
              uint32_t* __restrict__ sums) {
  using BlockReduce = cub::BlockReduce<U, kThreads>;
  __shared__ typename BlockReduce::TempStorage temp;
  const long long r_begin = (long long)blockIdx.x * tile_rows;
  const int n_rows = (int)min((long long)tile_rows, rows - r_begin);
  U x = 0;
  for (int r = threadIdx.x; r < n_rows; r += kThreads) x += (U)(int32_t)lengths[r_begin + r];
  const U total = BlockReduce(temp).Sum(x);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

template <typename E, typename L>
__global__ void __launch_bounds__(kThreads) pad(Args a, const uint32_t* __restrict__ sums) {
  using BlockReduce = cub::BlockReduce<U, kThreads>;
  using BlockScan = cub::BlockScan<U, kThreads>;
  __shared__ union {
    typename BlockReduce::TempStorage reduce;
    typename BlockScan::TempStorage scan;
  } temp;
  __shared__ int32_t s_off[kTileRows];
  __shared__ int32_t s_lim[kTileRows];
  __shared__ U s_prefix;

  const long long tile = blockIdx.x;
  const long long r_begin = tile * a.tile_rows;
  const int n_rows = (int)min((long long)a.tile_rows, a.rows - r_begin);
  const L* len = (const L*)a.lengths + r_begin;
  U items[kItems];
  L lv[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int row = threadIdx.x * kItems + k;
    lv[k] = row < n_rows ? len[row] : L(0);
    items[k] = (U)(int32_t)lv[k];
  }
  // the tile's prefix: the wrapping sum of the earlier tiles' sums (no
  // chain between tiles; O(tiles) loads a block, at most 8 a thread up to
  // 2^20 rows)
  U p = 0;
  for (long long u = threadIdx.x; u < tile; u += kThreads) p += __ldg(sums + u);
  p = BlockReduce(temp.reduce).Sum(p);
  if (threadIdx.x == 0) s_prefix = p;
  __syncthreads();
  BlockScan(temp.scan).InclusiveSum(items, items);
  const U prefix = s_prefix;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int row = threadIdx.x * kItems + k;
    if (row < n_rows) {
      s_off[row] = (int32_t)(prefix + items[k] - (U)(int32_t)lv[k]);
      s_lim[row] = lv[k] <= 0 ? 0 : ((long long)lv[k] < a.max_len ? (int)lv[k] : a.max_len);
    }
  }
  __syncthreads();

  // aligned 16-byte chunks of the tile's output block
  constexpr int kV = 16 / (int)sizeof(E);
  const E* vals = reinterpret_cast<const E*>(a.values);
  const uint32_t elems = (uint32_t)n_rows * (uint32_t)a.max_len;
  E* out = reinterpret_cast<E*>(a.out) + r_begin * a.max_len;
  const uint32_t n_chunks = (elems + kV - 1) / kV;
  for (uint32_t c = threadIdx.x; c < n_chunks; c += kThreads) {
    const uint32_t q = c * kV;
    int row = a.max_len == 1 ? (int)q : (int)(__umulhi(q, a.div_mul) >> a.div_shift);
    int j = (int)(q - (uint32_t)row * (uint32_t)a.max_len);
    int lim = s_lim[row];
    int32_t off = s_off[row];
    union {
      uint4 u;
      E e[kV];
    } v;
#pragma unroll
    for (int e = 0; e < kV; ++e) {
      E x = E(0);
      if (j < lim && a.nv > 0) {
        // the reference's int32 offset, wrapping, then its clip
        const int32_t idx = (int32_t)((uint32_t)off + (uint32_t)j);
        x = __ldg(vals + (idx < 0 ? 0 : (idx >= a.nv ? a.nv - 1 : idx)));
      }
      v.e[e] = x;
      if (++j == a.max_len && e + 1 < kV) {
        j = 0;
        if (++row < n_rows) {
          lim = s_lim[row];
          off = s_off[row];
        } else {
          lim = 0;
        }
      }
    }
    if (q + kV <= elems) {
      *reinterpret_cast<uint4*>(out + q) = v.u;
    } else {
      for (int e = 0; q + e < elems; ++e) out[q + e] = v.e[e];
    }
  }
}

template <typename E, typename L>
int launch(const Args& a, long long ntiles, uint32_t* sums, cudaStream_t s) {
  tile_sums<L><<<(unsigned)ntiles, kThreads, 0, s>>>((const L*)a.lengths, a.rows, a.tile_rows,
                                                      sums);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  pad<E, L><<<(unsigned)ntiles, kThreads, 0, s>>>(a, sums);
  return (int)cudaGetLastError();
}

template <typename L>
int by_width(int elem_bytes, const Args& a, long long ntiles, uint32_t* sums, cudaStream_t s) {
  switch (elem_bytes) {
    case 1:
      return launch<uint8_t, L>(a, ntiles, sums, s);
    case 4:
      return launch<uint32_t, L>(a, ntiles, sums, s);
    case 8:
      return launch<unsigned long long, L>(a, ntiles, sums, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

inline long long num_tiles(long long rows, int max_len, int elem_bytes) {
  const int t = tile_rows_for(max_len, elem_bytes);
  return (rows + t - 1) / t;
}

}  // namespace

// 64-bit words of scratch (the tiles' length sums) a padding of `rows` rows
// needs.
extern "C" int pqt_pad_ragged_scratch_words(long long rows, int max_len, int elem_bytes) {
  return (int)((num_tiles(rows, max_len, elem_bytes) + 1) / 2);
}

// `out` (rows x max_len elements) must be 16-byte aligned; `scratch` holds
// pqt_pad_ragged_scratch_words 64-bit words. max_len * 16 must stay below
// 2^31.
extern "C" int pqt_pad_ragged(const void* values, long long nv, int elem_bytes,
                              const void* lengths, int len_bytes, long long rows,
                              int max_len, void* out, void* scratch, void* stream) {
  if (rows <= 0 || max_len <= 0) return 0;
  if ((len_bytes != 4 && len_bytes != 8) || (long long)max_len * 16 > INT_MAX ||
      (uintptr_t)out % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  Args a;
  a.values = (const uint8_t*)values;
  a.nv = nv;
  a.lengths = lengths;
  a.rows = rows;
  a.max_len = max_len;
  a.tile_rows = tile_rows_for(max_len, elem_bytes);
  // q / d for 0 <= q < 2^31 and d >= 2: p = 31 + ceil(log2 d), m = ceil(2^p / d)
  // (CUTLASS's FastDivmod); d == 1 divides by nothing
  int l = 0;
  while ((1LL << l) < max_len) ++l;
  a.div_mul = max_len > 1 ? (uint32_t)(((1ULL << (31 + l)) + max_len - 1) / max_len) : 0u;
  a.div_shift = max_len > 1 ? l - 1 : 0;
  a.out = (uint8_t*)out;
  const long long ntiles = num_tiles(rows, max_len, elem_bytes);
  auto* sums = (uint32_t*)scratch;
  return len_bytes == 4 ? by_width<int32_t>(elem_bytes, a, ntiles, sums, s)
                        : by_width<long long>(elem_bytes, a, ntiles, sums, s);
}
