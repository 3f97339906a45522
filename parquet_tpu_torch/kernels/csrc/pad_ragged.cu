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
// A row whose output exceeds kTileBytes (wide rows, of any max_len: a
// 16-row tile of 2^27 columns would pass 2^31 elements) takes launch 2 as
// pad_wide instead: each block writes one kTileBytes span of the flat
// output (16-byte aligned, as the spans are), which lies in one row or
// crosses into the next, so the block needs two rows' offsets and lengths.
// It finds its row and first column by one 64-bit division, reduces the
// tile sums before the row's tile and the lengths of the tile's rows before
// it, and indexes the span in 32 bits from its start. The column j enters
// as the reference's int32 arange does, wrapping past 2^31 - 1: the slot is
// kept when int32(j) < lengths[r] (in the length's type) and reads
// values[clip(int32(offs[r] + j), 0, nv - 1)]. Tiles of wide rows take
// kTileRows rows (they only carry length sums), so every 32-bit index of
// pad stays below 16 x kTileBytes.
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

#include <cstdint>
#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 2;
constexpr int kTileRows = kThreads * kItems;  // device_ops.PAD_RAGGED_TILE
constexpr int kTileBytes = 32768;  // output bytes a tile aims at; a span of wider rows
static_assert(kTileRows % 16 == 0, "16-byte aligned tiles");

using U = uint32_t;

struct Args {
  const uint8_t* values;
  long long nv;
  const void* lengths;
  long long rows;
  long long max_len;
  int tile_rows;
  uint32_t div_mul;  // q / max_len = __umulhi(q, div_mul) >> div_shift, q < 2^31
  int div_shift;
  uint8_t* out;
};

// A row's output exceeds a tile's aim: pad_wide writes it in spans.
inline bool wide_rows(long long max_len, int elem_bytes) {
  return max_len * elem_bytes > kTileBytes;
}

// Rows a tile takes: kTileRows, or fewer (a multiple of 16, at least 16)
// when a row's output is wide; kTileRows again for wide rows, whose tiles
// only carry length sums.
inline int tile_rows_for(long long max_len, int elem_bytes) {
  const long long row_bytes = max_len * elem_bytes;
  if (wide_rows(max_len, elem_bytes)) return kTileRows;
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
  const int max_len = (int)a.max_len;  // narrow rows: at most kTileBytes
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
      s_lim[row] = lv[k] <= 0 ? 0 : ((long long)lv[k] < max_len ? (int)lv[k] : max_len);
    }
  }
  __syncthreads();

  // aligned 16-byte chunks of the tile's output block
  constexpr int kV = 16 / (int)sizeof(E);
  const E* vals = reinterpret_cast<const E*>(a.values);
  const uint32_t elems = (uint32_t)n_rows * (uint32_t)max_len;
  E* out = reinterpret_cast<E*>(a.out) + r_begin * max_len;
  const uint32_t n_chunks = (elems + kV - 1) / kV;
  for (uint32_t c = threadIdx.x; c < n_chunks; c += kThreads) {
    const uint32_t q = c * kV;
    int row = max_len == 1 ? (int)q : (int)(__umulhi(q, a.div_mul) >> a.div_shift);
    int j = (int)(q - (uint32_t)row * (uint32_t)max_len);
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
      if (++j == max_len && e + 1 < kV) {
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

// One kTileBytes span of the flat output of wide rows a block; the span
// starts in row r = first / max_len and at most crosses into row r + 1.
template <typename E, typename L>
__global__ void __launch_bounds__(kThreads) pad_wide(Args a, const uint32_t* __restrict__ sums) {
  using BlockReduce = cub::BlockReduce<U, kThreads>;
  __shared__ typename BlockReduce::TempStorage temp;
  __shared__ uint32_t s_off[2];  // offs + the part's first column, wrapping
  __shared__ long long s_len[2];
  constexpr int kSpan = kTileBytes / (int)sizeof(E);
  const long long first = (long long)blockIdx.x * kSpan;
  const long long row = first / a.max_len;
  const long long j0 = first - row * a.max_len;
  const uint32_t col0 = (uint32_t)j0;  // the first column, mod 2^32
  const int elems = (int)min((long long)kSpan, a.rows * a.max_len - first);
  // the span's slots in row `row`; the rest lie in row + 1
  const int cut = (int)min((long long)elems, a.max_len - j0);
  const L* len = (const L*)a.lengths;
  // the row's offset: the wrapping sum of the tile sums before its tile and
  // of the lengths of its tile's rows before it
  const long long tile = row / a.tile_rows;
  U p = 0;
  for (long long u = threadIdx.x; u < tile; u += kThreads) p += __ldg(sums + u);
  for (long long r = tile * a.tile_rows + threadIdx.x; r < row; r += kThreads)
    p += (U)(int32_t)len[r];
  p = BlockReduce(temp).Sum(p);
  if (threadIdx.x == 0) {
    for (int k = 0; k < 2; ++k) {
      const L l = row + k < a.rows ? len[row + k] : L(0);
      s_off[k] = k ? p : p + col0;
      s_len[k] = (long long)l;
      p += (U)(int32_t)l;
    }
  }
  __syncthreads();
  const uint32_t off0 = s_off[0], off1 = s_off[1];
  const long long len0 = s_len[0], len1 = s_len[1];

  constexpr int kV = 16 / (int)sizeof(E);
  const E* vals = reinterpret_cast<const E*>(a.values);
  E* out = reinterpret_cast<E*>(a.out) + first;
  const int n_chunks = (elems + kV - 1) / kV;
  for (int c = threadIdx.x; c < n_chunks; c += kThreads) {
    const int q = c * kV;
    union {
      uint4 u;
      E e[kV];
    } v;
#pragma unroll
    for (int e = 0; e < kV; ++e) {
      const bool next = q + e >= cut;  // in row + 1
      const uint32_t t = (uint32_t)(next ? q + e - cut : q + e);  // slots into the part
      E x = E(0);
      // the reference's int32 column, then its int32 offset, wrapping, and
      // its clip
      if ((long long)(int32_t)(next ? t : col0 + t) < (next ? len1 : len0) && a.nv > 0) {
        const int32_t idx = (int32_t)((next ? off1 : off0) + t);
        x = __ldg(vals + (idx < 0 ? 0 : (idx >= a.nv ? a.nv - 1 : idx)));
      }
      v.e[e] = x;
    }
    if (q + kV <= elems) {
      *reinterpret_cast<uint4*>(out + q) = v.u;
    } else {
      for (int e = 0; q + e < elems; ++e) out[q + e] = v.e[e];
    }
  }
}

template <typename E, typename L>
int launch(const Args& a, long long ntiles, bool wide, uint32_t* sums, cudaStream_t s) {
  tile_sums<L><<<(unsigned)ntiles, kThreads, 0, s>>>((const L*)a.lengths, a.rows, a.tile_rows,
                                                      sums);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  if (wide) {
    constexpr long long kSpan = kTileBytes / (long long)sizeof(E);
    const long long spans = (a.rows * a.max_len + kSpan - 1) / kSpan;
    pad_wide<E, L><<<(unsigned)spans, kThreads, 0, s>>>(a, sums);
  } else {
    pad<E, L><<<(unsigned)ntiles, kThreads, 0, s>>>(a, sums);
  }
  return (int)cudaGetLastError();
}

template <typename L>
int by_width(int elem_bytes, const Args& a, long long ntiles, bool wide, uint32_t* sums,
             cudaStream_t s) {
  switch (elem_bytes) {
    case 1:
      return launch<uint8_t, L>(a, ntiles, wide, sums, s);
    case 4:
      return launch<uint32_t, L>(a, ntiles, wide, sums, s);
    case 8:
      return launch<unsigned long long, L>(a, ntiles, wide, sums, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

inline long long num_tiles(long long rows, long long max_len, int elem_bytes) {
  const int t = tile_rows_for(max_len, elem_bytes);
  return (rows + t - 1) / t;
}

}  // namespace

// 64-bit words of scratch (the tiles' length sums) a padding of `rows` rows
// needs.
extern "C" int pqt_pad_ragged_scratch_words(long long rows, long long max_len, int elem_bytes) {
  return (int)((num_tiles(rows, max_len, elem_bytes) + 1) / 2);
}

// `out` (rows x max_len elements) must be 16-byte aligned; `scratch` holds
// pqt_pad_ragged_scratch_words 64-bit words.
extern "C" int pqt_pad_ragged(const void* values, long long nv, int elem_bytes,
                              const void* lengths, int len_bytes, long long rows,
                              long long max_len, void* out, void* scratch, void* stream) {
  if (rows <= 0 || max_len <= 0) return 0;
  if ((len_bytes != 4 && len_bytes != 8) || (uintptr_t)out % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  Args a;
  a.values = (const uint8_t*)values;
  a.nv = nv;
  a.lengths = lengths;
  a.rows = rows;
  a.max_len = max_len;
  a.tile_rows = tile_rows_for(max_len, elem_bytes);
  const bool wide = wide_rows(max_len, elem_bytes);
  // pad's q / d for 0 <= q < 2^31 and 2 <= d <= kTileBytes: p = 31 +
  // ceil(log2 d), m = ceil(2^p / d) (CUTLASS's FastDivmod); d == 1 divides
  // by nothing. pad's q stays below 16 x kTileBytes; pad_wide does not
  // divide per slot.
  int l = 0;
  while (!wide && (1LL << l) < max_len) ++l;
  a.div_mul = !wide && max_len > 1 ? (uint32_t)(((1ULL << (31 + l)) + max_len - 1) / max_len) : 0u;
  a.div_shift = !wide && max_len > 1 ? l - 1 : 0;
  a.out = (uint8_t*)out;
  const long long ntiles = num_tiles(rows, max_len, elem_bytes);
  auto* sums = (uint32_t*)scratch;
  return len_bytes == 4 ? by_width<int32_t>(elem_bytes, a, ntiles, wide, sums, s)
                        : by_width<long long>(elem_bytes, a, ntiles, wide, sums, s);
}
