// Compaction of rows under a mask: values[mask] into a buffer of out_pad
// rows, in three entry points.
//
// Replaces parquet_tpu/kernels/device_ops.py:mask_take_device (under XLA:
// a cumsum of the mask, a scatter-max of the kept positions' indices into
// src[out_pad + 1] and a gather values[src]) and the per-leaf
// `a[sel][:kept]` of parquet_tpu/core/reader.py:_device_filter_rows:
//
//   pqt_mask_scan   src[pos] = i for each kept entry i at output position
//                   pos = count(mask[:i + 1]) - 1 < out_pad, 0 in
//                   [count, out_pad), and the full count (int64, the
//                   reference's dtype under x64). One scan serves every
//                   leaf of a row group: the reader syncs once for the
//                   count and gathers each leaf with pqt_take_rows.
//   pqt_mask_take   the same placement writing out[pos] = values[i] itself
//                   (rows of any byte width), values[0] in [count,
//                   out_pad): the single-leaf call, with no src round trip.
//   pqt_take_rows   out[j] = rows[src[j]] for j < min(count, out_rows), and
//                   rows[0] past it (zeros when there are no rows).
//
// The scan is two launches over a bounded grid (at most kMaxBlocks blocks,
// about two waves on an H100), each block owning a contiguous chunk of the
// mask, read as 16-byte vectors (a mask that does not start on 16 bytes,
// such as mask[3:], reads its head and tail vectors byte by byte):
//
//   1. chunk_counts: each block the number of nonzero mask bytes in its
//      chunk;
//   2. place: each block reduces all chunks' counts itself (its prefix and
//      the total; no chain between blocks, no n-element scratch), then walks
//      its chunk in tiles of kTile entries: a BlockScan of the tile's
//      per-vector counts stages the kept entries' indices in shared memory,
//      and a sink writes the tile's outputs from them, consecutive threads
//      on consecutive outputs. The blocks then write [count, out_pad) as a
//      grid-stride tail (no memset), and block 0 the count.
//
// pqt_take_rows is output-stationary: consecutive threads write consecutive
// 16-byte words of the output where they can. Rows of one narrower word
// (a 1-D column) go 16 / width rows to a thread, gathered together and
// stored as one 16-byte word; wider rows go word by word (16-byte words
// where the row width and the pointers allow). Each thread loads the count
// beside its positions (one L1 line a block; a block barrier to share it
// was slower), and a small gather spreads over the SMs.
//
// Bound on an H100: memory. Bytes: the mask read once (1 B per entry), the
// kept rows read and written once each, and for the two-call route src
// written and read (4 B per kept row). Beyond them the mask is read twice
// (once a launch) and 4 B of count a block. At taxi fare_cents group 0
// under F_taxi (n = 1,048,576 int32, 166,371 kept) on an H100 80GB HBM3 at
// 700 W, pqt_mask_take takes about 0.0055 ms against a 0.0007 ms bound,
// where the former five launches (a memset, a three-pass scan through an
// int32 partial[n], one thread a row) took 0.0132; the scan alone at the
// reader's out_pad = n 0.0061 against 0.0121; pqt_take_rows 0.0022 against
// 0.0023 on that column, and 0.0062 against 0.0195 on 64-byte rows
// (PERF.md §6).

#include <cstdint>
#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileVecs = kThreads;    // one 16-byte mask vector a thread a tile
constexpr int kTile = 16 * kTileVecs;  // device_ops.MASK_TAKE_TILE
constexpr int kMaxBlocks = 1024;       // device_ops.MASK_TAKE_BLOCKS
constexpr int kRowWords = 4;           // output words a thread of take_wide copies
constexpr int kNarrowThreads = 128;    // threads a block of take_narrow
constexpr int kSpreadBlocks = 132;     // blocks a small take_wide spreads over (the H100's SMs)

struct Mask {
  const uint8_t* base;  // 16-byte aligned; mask[i] is base[head + i]
  int head;
  long long n;
  long long nvec;  // 16-byte vectors covering [head, head + n)
  long long cv;    // vectors a block's chunk (a multiple of kTileVecs)
  int blocks;
};

Mask make_mask(const void* mask, long long n) {
  Mask m;
  const uintptr_t p = (uintptr_t)mask;
  m.base = (const uint8_t*)(p & ~(uintptr_t)15);
  m.head = (int)(p & 15);
  m.n = n;
  m.nvec = (m.head + n + 15) / 16;
  const long long tiles = (m.nvec + kTileVecs - 1) / kTileVecs;
  const long long per_block = (tiles + kMaxBlocks - 1) / kMaxBlocks;
  m.cv = per_block * kTileVecs;
  m.blocks = (int)((m.nvec + m.cv - 1) / m.cv);
  return m;
}

// the high bit of each nonzero byte
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t x) {
  return (((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x) & 0x80808080u;
}

// Bit k set when entry 16 v - head + k lies in [0, n) and is nonzero.
__device__ __forceinline__ uint32_t flags(const Mask& m, long long v) {
  const long long i0 = 16 * v - m.head;
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if (i0 >= 0 && i0 + 16 <= m.n) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(m.base) + v);
    w[0] = q.x;
    w[1] = q.y;
    w[2] = q.z;
    w[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const long long i = i0 + k;
      if (i >= 0 && i < m.n && m.base[16 * v + k] != 0) w[k >> 2] |= 0x80u << (8 * (k & 3));
    }
  }
  uint32_t f = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t z = nonzero_bytes(w[j]);
    f |= (((z >> 7) & 1u) | ((z >> 14) & 2u) | ((z >> 21) & 4u) | ((z >> 28) & 8u)) << (4 * j);
  }
  return f;
}

__global__ void __launch_bounds__(kThreads) chunk_counts(Mask m, uint32_t* __restrict__ counts) {
  using BlockReduce = cub::BlockReduce<uint32_t, kThreads>;
  __shared__ typename BlockReduce::TempStorage temp;
  const long long v0 = (long long)blockIdx.x * m.cv;
  const long long v1 = min(v0 + m.cv, m.nvec);
  uint32_t c = 0;
  for (long long v = v0 + threadIdx.x; v < v1; v += kThreads) c += __popc(flags(m, v));
  c = BlockReduce(temp).Sum(c);
  if (threadIdx.x == 0) counts[blockIdx.x] = c;
}

// A sink writes a tile's outputs from the staged indices of its kept
// entries (all threads call it) and the positions past the count.
struct SrcSink {
  int32_t* src;

  __device__ __forceinline__ void tile(const int32_t* idx, int k, long long pos,
                                       long long out_pad) const {
    const long long lim = min((long long)k, out_pad - pos);
    for (int j = threadIdx.x; j < lim; j += kThreads) src[pos + j] = idx[j];
  }
  __device__ __forceinline__ void fill(long long from, long long out_pad) const {
    const long long stride = (long long)gridDim.x * kThreads;
    for (long long p = from + (long long)blockIdx.x * kThreads + threadIdx.x; p < out_pad;
         p += stride)
      src[p] = 0;
  }
};

template <typename W>
struct RowSink {
  const W* values;
  long long wpr;  // words a row, at least 1
  W* out;

  __device__ __forceinline__ void tile(const int32_t* idx, int k, long long pos,
                                       long long out_pad) const {
    const int rows = (int)min((long long)k, out_pad - pos);
    W* o = out + pos * wpr;
    if (wpr == 1) {
      for (int j = threadIdx.x; j < rows; j += kThreads) o[j] = __ldg(values + idx[j]);
    } else {
      for (long long l = threadIdx.x; l < (long long)rows * wpr; l += kThreads) {
        const long long j = l / wpr;
        o[l] = __ldg(values + (long long)idx[j] * wpr + (l - j * wpr));
      }
    }
  }
  __device__ __forceinline__ void fill(long long from, long long out_pad) const {
    const long long stride = (long long)gridDim.x * kThreads;
    for (long long l = from * wpr + (long long)blockIdx.x * kThreads + threadIdx.x;
         l < out_pad * wpr; l += stride)
      out[l] = __ldg(values + (wpr == 1 ? 0 : l % wpr));
  }
};

template <typename Sink>
__global__ void __launch_bounds__(kThreads)
    place(Mask m, const uint32_t* __restrict__ counts, long long out_pad,
          long long* __restrict__ count, Sink sink) {
  using BlockReduce = cub::BlockReduce<unsigned long long, kThreads>;
  using BlockScan = cub::BlockScan<int, kThreads>;
  __shared__ union {
    typename BlockReduce::TempStorage reduce;
    typename BlockScan::TempStorage scan;
  } temp;
  __shared__ int32_t s_idx[kTile];
  __shared__ unsigned long long s_sums;

  // (the earlier chunks' count << 32) + every chunk's count: both below 2^31
  unsigned long long x = 0;
  for (int u = threadIdx.x; u < m.blocks; u += kThreads) {
    const unsigned long long c = __ldg(counts + u);
    x += c + (u < (int)blockIdx.x ? c << 32 : 0ull);
  }
  x = BlockReduce(temp.reduce).Sum(x);
  if (threadIdx.x == 0) {
    s_sums = x;
    if (blockIdx.x == 0) *count = (long long)(x & 0xFFFFFFFFull);
  }
  __syncthreads();
  const long long total = (long long)(s_sums & 0xFFFFFFFFull);
  long long pos = (long long)(s_sums >> 32);

  const long long v1 = min((long long)(blockIdx.x + 1) * m.cv, m.nvec);
  for (long long tv = (long long)blockIdx.x * m.cv; tv < v1 && pos < out_pad; tv += kTileVecs) {
    const long long v = tv + threadIdx.x;
    const uint32_t f = v < v1 ? flags(m, v) : 0u;
    int r, agg;
    BlockScan(temp.scan).ExclusiveSum(__popc(f), r, agg);
    const long long i0 = 16 * v - m.head;
    for (uint32_t g = f; g; g &= g - 1) s_idx[r++] = (int32_t)(i0 + __ffs(g) - 1);
    __syncthreads();
    sink.tile(s_idx, agg, pos, out_pad);
    pos += agg;
    __syncthreads();
  }
  sink.fill(total, out_pad);
}

template <typename Sink>
int launch_scan(const Mask& m, long long out_pad, void* count, void* scratch, const Sink& sink,
                cudaStream_t s) {
  chunk_counts<<<m.blocks, kThreads, 0, s>>>(m, (uint32_t*)scratch);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  place<Sink><<<m.blocks, kThreads, 0, s>>>(m, (const uint32_t*)scratch, out_pad,
                                             (long long*)count, sink);
  return (int)cudaGetLastError();
}

// Rows of one word narrower than 16 bytes: a thread gathers the 16 / sizeof(W)
// consecutive output rows of one 16-byte output word, all loads in flight
// together, and stores the word at once.
template <typename W>
__global__ void __launch_bounds__(kNarrowThreads)
    take_narrow(const W* __restrict__ rows, long long n_src, const int32_t* __restrict__ src,
                const long long* __restrict__ count, long long out_rows, W* __restrict__ out) {
  constexpr int V = 16 / (int)sizeof(W);
  const long long j0 = ((long long)blockIdx.x * kNarrowThreads + threadIdx.x) * V;
  if (j0 >= out_rows) return;
  const long long c = min(__ldg(count), out_rows);
  int32_t at[V];
#pragma unroll
  for (int v = 0; v < V; ++v) at[v] = j0 + v < out_rows ? __ldg(src + j0 + v) : 0;
  union {
    uint4 u;
    W w[V];
  } r;
#pragma unroll
  for (int v = 0; v < V; ++v)
    r.w[v] = n_src == 0 ? W() : __ldg(rows + (j0 + v < c ? at[v] : 0));
  if (j0 + V <= out_rows) {
    *reinterpret_cast<uint4*>(out + j0) = r.u;
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (j0 + v < out_rows) out[j0 + v] = r.w[v];
  }
}

// Rows of several words (or one 16-byte word): a block takes rpb rows, at
// most kThreads * kRowWords words, and each thread kRowWords of them,
// consecutive threads on consecutive words, all loads in flight together.
// A block of one row (a row wider than that, or a gather of at most
// kSpreadBlocks rows) loops over the row.
template <typename W>
__global__ void __launch_bounds__(kThreads)
    take_wide(const W* __restrict__ rows, long long n_src, long long wpr, int rpb,
              const int32_t* __restrict__ src, const long long* __restrict__ count,
              long long out_rows, W* __restrict__ out) {
  const long long row0 = (long long)blockIdx.x * rpb;
  const int nrows = (int)min((long long)rpb, out_rows - row0);
  const long long c = min(__ldg(count), out_rows) - row0;
  W* o = out + row0 * wpr;
  if (rpb == 1) {
    const int32_t s0 = __ldg(src + row0);
    const W* s = rows + (c > 0 ? (long long)s0 : 0) * wpr;
    for (long long k = threadIdx.x; k < wpr; k += kThreads)
      o[k] = n_src == 0 ? W() : __ldg(s + k);
    return;
  }
  const unsigned w = (unsigned)wpr, words = (unsigned)nrows * w;
  W v[kRowWords];
#pragma unroll
  for (int i = 0; i < kRowWords; ++i) {
    const unsigned l = threadIdx.x + i * kThreads;
    if (l < words) {
      const unsigned j = l / w;
      const int32_t sj = __ldg(src + row0 + j);
      const long long r = (long long)j < c ? (long long)sj : 0;
      v[i] = n_src == 0 ? W() : __ldg(rows + r * wpr + (l - j * w));
    }
  }
#pragma unroll
  for (int i = 0; i < kRowWords; ++i) {
    const unsigned l = threadIdx.x + i * kThreads;
    if (l < words) o[l] = v[i];
  }
}

template <typename W>
int launch_take(const void* rows, long long n_src, long long row_bytes, const void* src,
                const void* count, long long out_rows, void* out, cudaStream_t s) {
  const long long wpr = row_bytes / (long long)sizeof(W);
  if constexpr (sizeof(W) < 16) {
    if (wpr == 1) {
      const long long per_block = (long long)kNarrowThreads * (16 / sizeof(W));
      take_narrow<W><<<(unsigned)((out_rows + per_block - 1) / per_block), kNarrowThreads, 0,
                       s>>>((const W*)rows, n_src, (const int32_t*)src,
                            (const long long*)count, out_rows, (W*)out);
      return (int)cudaGetLastError();
    }
  }
  // rows a block: at most kThreads * kRowWords words, and few enough that a
  // small gather still spreads over the SMs
  const long long most = wpr >= kThreads * kRowWords ? 1 : kThreads * kRowWords / wpr;
  const long long rpb = max(1ll, min(most, (out_rows + kSpreadBlocks - 1) / kSpreadBlocks));
  take_wide<W><<<(unsigned)((out_rows + rpb - 1) / rpb), kThreads, 0, s>>>(
      (const W*)rows, n_src, wpr, rpb, (const int32_t*)src, (const long long*)count, out_rows,
      (W*)out);
  return (int)cudaGetLastError();
}

template <typename W>
int launch_mask_take(const Mask& m, long long out_pad, const void* values, long long row_bytes,
                     void* out, void* count, void* scratch, cudaStream_t s) {
  RowSink<W> sink{(const W*)values, row_bytes / (long long)sizeof(W), (W*)out};
  return launch_scan(m, out_pad, count, scratch, sink, s);
}

}  // namespace

// mask: bool[n], n < 2^31; src: int32[out_pad]; count: int64[1]; scratch:
// kMaxBlocks 32-bit words (the chunks' counts).
extern "C" int pqt_mask_scan(const void* mask, long long n, long long out_pad, void* src,
                             void* count, void* scratch, void* stream) {
  if (n <= 0) return 0;
  return launch_scan(make_mask(mask, n), out_pad, count, scratch, SrcSink{(int32_t*)src},
                     (cudaStream_t)stream);
}

// values: n rows of row_bytes > 0 bytes; out: out_pad rows; `word` (16, 8,
// 4, 2 or 1) divides row_bytes and the alignment of `values` and `out`.
extern "C" int pqt_mask_take(const void* mask, long long n, long long out_pad,
                             const void* values, long long row_bytes, int word, void* out,
                             void* count, void* scratch, void* stream) {
  if (n <= 0) return 0;
  if (word <= 0 || row_bytes <= 0 || row_bytes % word) return (int)cudaErrorInvalidValue;
  const Mask m = make_mask(mask, n);
  cudaStream_t s = (cudaStream_t)stream;
  switch (word) {
    case 16:
      return launch_mask_take<uint4>(m, out_pad, values, row_bytes, out, count, scratch, s);
    case 8:
      return launch_mask_take<unsigned long long>(m, out_pad, values, row_bytes, out, count,
                                                  scratch, s);
    case 4:
      return launch_mask_take<uint32_t>(m, out_pad, values, row_bytes, out, count, scratch, s);
    case 2:
      return launch_mask_take<uint16_t>(m, out_pad, values, row_bytes, out, count, scratch, s);
    case 1:
      return launch_mask_take<uint8_t>(m, out_pad, values, row_bytes, out, count, scratch, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// rows: n_src rows of row_bytes bytes; src: int32[>= out_rows]; count:
// int64[1] on the device; out: out_rows rows, 16-byte aligned. `word` (16,
// 8, 4, 2 or 1) divides row_bytes and the alignment of `rows`.
extern "C" int pqt_take_rows(const void* rows, long long n_src, long long row_bytes,
                             int word, const void* src, const void* count,
                             long long out_rows, void* out, void* stream) {
  if (out_rows <= 0 || row_bytes <= 0) return 0;
  if (word <= 0 || row_bytes % word || (uintptr_t)out % 16) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (word) {
    case 16:
      return launch_take<uint4>(rows, n_src, row_bytes, src, count, out_rows, out, s);
    case 8:
      return launch_take<unsigned long long>(rows, n_src, row_bytes, src, count, out_rows,
                                             out, s);
    case 4:
      return launch_take<uint32_t>(rows, n_src, row_bytes, src, count, out_rows, out, s);
    case 2:
      return launch_take<uint16_t>(rows, n_src, row_bytes, src, count, out_rows, out, s);
    case 1:
      return launch_take<uint8_t>(rows, n_src, row_bytes, src, count, out_rows, out, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
