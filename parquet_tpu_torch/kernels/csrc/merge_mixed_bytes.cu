// Mixed dict/PLAIN byte-array merge: the ragged (data, offsets) column of a
// chunk whose dictionary pages and PLAIN pages interleave.
//
// Replaces parquet_tpu/kernels/device_ops.py:merge_mixed_bytes_device (under
// XLA: a per-row searchsorted and gathers, a cumsum, then a searchsorted per
// OUTPUT BYTE into the offsets to find each byte's row). A row of a dict
// page copies dictionary entry idx_all[aux + rel] (doff offsets into the
// head of `pool`); a row of a PLAIN page copies bytes po32[aux + rel] ..
// po32[aux + rel + 1] of its page, whose payload starts at src_base[page]
// in `pool`.
//
// One kernel, each block a tile of kTile consecutive rows, each thread
// kItems of them:
//
//   1. the tile's index from a counter (scan.cuh next_tile), so a tile's
//      look-back only ever waits for tiles that have started;
//   2. warp 0 finds the pages of the tile's first and last rows in the page
//      row starts (scan.cuh warp_count_le2), and the block stages the page
//      tables (kind, row start, aux, source base) over that range in shared
//      memory; a tile spanning more than kStagePages pages (pages shorter
//      than kTile / kStagePages rows on average) reads them in place (the
//      whole table staged without the search measured no faster);
//   3. each thread finds its first row's page by a binary search there and
//      walks forward, then loads its rows' sources: a dict row's index and
//      its two dictionary offsets, a PLAIN row's two offsets (every load of
//      one level goes out before any is used);
//   4. the lengths are scanned with scan.cuh's single-pass look-back
//      (seg_tile_scan, no segment reset); each row's source start and
//      output offset go to shared memory, and the block writes
//      offsets[i + 1] from there, consecutive threads on consecutive rows
//      (offsets[0] = 0 from tile 0);
//   5. the tile's output bytes are one range, [prefix, prefix + total). The
//      block copies it output-stationary: each thread takes aligned 16-byte
//      chunks of `data` (the block strides over the range, so a row of any
//      length is handled), finds the row of a chunk's first byte by a binary
//      search of the tile's offsets and walks forward. Rows whose sources
//      continue one another (consecutive rows of a PLAIN page) form one
//      piece; a piece reads the 4-byte words of `pool` it spans (at most
//      five) and funnel-shifts them into place. A tile that is one piece
//      (all of its rows from one PLAIN page: most of them on the main path;
//      its rows' least and greatest source - output offset, folded at the
//      scan's barrier, are equal) knows each chunk's source without the
//      search. A chunk is one 16-byte
//      store; a chunk the range shares with a neighbouring tile (its head or
//      tail) is stored byte by byte for the tile's own bytes, so no two
//      tiles write one byte.
//
// The JAX pipeline pads its inputs to buckets (idx_all with zeros, the
// dictionary offsets with their last value, the PLAIN offsets with zeros)
// and the program clamps against the padded shapes. The kernel replicates
// those reads from the padded sizes (d_pad, doff_pad, e_pad) without the
// padding: an index past the dictionary reads an empty entry. A source
// byte outside the pool reads the pool's first or last byte (the program's
// clamped gather); such a piece, or any piece when `pool` is not 4-byte
// aligned, is read byte by byte.
//
// Bound on an H100: memory. Bytes the function must move: the dict rows'
// indices, the dictionary offsets and payload, the PLAIN offsets and
// payload, the output bytes and offsets, each once: for the main path's
// `zone` chunk (2^20 rows of about 17 bytes) about 48 MB, 14 us at 3.35
// TB/s (measured about 37 us on an H100 80GB HBM3 at 700 W, where the
// first design's four launches took 240; PERF.md §6). Beyond it the design
// reads the search's samples, 16 bytes of tile
// descriptor a tile (zeroed before the launch), and a chunk's words twice
// where two pieces share one. No scratch of n_rows elements is written.

#include <climits>

#include "scan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;  // device_ops.MERGE_BYTES_TILE
constexpr int kStagePages = 64;
static_assert(kStagePages < kThreads, "one staged page a thread");

using U = unsigned long long;

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
  bool pool_words;  // pool is 4-byte aligned: pieces read it by words
};

// A range of the page tables: staged in shared memory or in place.
struct Pages {
  const int32_t* kind;
  const int32_t* row_start;  // n + 1 entries
  const int32_t* aux;
  const long long* src_base;
  int n;
};

__device__ __forceinline__ long long clampll(long long x, long long lo, long long hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// A 16-byte chunk in two registers: byte b at bits 8 (b % 8) of half b / 8.
struct Chunk {
  unsigned long long lo = 0, hi = 0;

  __device__ __forceinline__ void put_byte(int b, uint32_t x) {
    if (b < 8) lo |= (unsigned long long)x << (8 * b);
    else hi |= (unsigned long long)x << (8 * (b - 8));
  }
  __device__ __forceinline__ uint8_t byte(int b) const {
    return (uint8_t)(b < 8 ? lo >> (8 * b) : hi >> (8 * (b - 8)));
  }
};

// Bytes [lo, hi) of a 16-byte chunk, byte b read from pool[src + b], into o.
__device__ __forceinline__ void put_piece(const Args& a, Chunk& o, int lo, int hi,
                                          long long src) {
  if (a.pool_words && src + lo >= 0 && src + hi <= a.n_pool) {
    const long long w0 = src >> 2;  // floor: src may lie below 0 when lo > 0
    const unsigned sh = (unsigned)(src & 3) * 8;
    const long long m_lo = ((src + lo) >> 2) - w0, m_hi = ((src + hi - 1) >> 2) - w0;
    const uint32_t* p32 = reinterpret_cast<const uint32_t*>(a.pool);
    uint32_t w[5];
#pragma unroll
    for (int m = 0; m < 5; ++m) w[m] = m >= m_lo && m <= m_hi ? __ldg(p32 + w0 + m) : 0u;
    uint32_t v[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int b_lo = min(max(lo - 4 * m, 0), 4), b_hi = min(max(hi - 4 * m, 0), 4);
      const uint32_t keep =
          (uint32_t)(((1ull << (8 * b_hi)) - 1ull) & ~((1ull << (8 * b_lo)) - 1ull));
      v[m] = __funnelshift_r(w[m], w[m + 1], sh) & keep;
    }
    o.lo |= (unsigned long long)v[1] << 32 | v[0];
    o.hi |= (unsigned long long)v[3] << 32 | v[2];
  } else {
    for (int b = lo; b < hi; ++b) o.put_byte(b, a.pool[clampll(src + b, 0, a.n_pool - 1)]);
  }
}

__global__ void __launch_bounds__(kThreads)
    merge(Args a, long long data_bytes, uint8_t* __restrict__ data,
          long long* __restrict__ offsets, scan::SegTiles d) {
  __shared__ typename scan::SegBlockScan<U, kThreads>::TempStorage scan_temp;
  __shared__ unsigned int tile_slot;
  __shared__ int s_pages[2];
  __shared__ int32_t s_kind[kStagePages];
  __shared__ int32_t s_prs[kStagePages + 1];
  __shared__ int32_t s_aux[kStagePages];
  __shared__ long long s_base[kStagePages];
  __shared__ long long s_start[kTile];    // each row's source start
  __shared__ long long s_off[kTile + 1];  // each row's output start; [kTile] the tile's end
  // the least and greatest (source start - output start) of the rows with bytes
  __shared__ long long s_dmin, s_dmax;

  if (threadIdx.x == 0) {
    s_dmin = LLONG_MAX;
    s_dmax = LLONG_MIN;
  }
  const long long tile = scan::next_tile(d, &tile_slot);
  const long long begin = tile * kTile;
  const long long last = min(begin + kTile, a.n_rows) - 1;
  if (threadIdx.x < 32) {
    // the page of row i: the page row starts prs[1..p_pad] at or below i,
    // clamped to the last page
    const int2 c = scan::warp_count_le2(a.prs + 1, a.p_pad, begin, last);
    if (threadIdx.x == 0) {
      s_pages[0] = min(c.x, a.p_pad - 1);
      s_pages[1] = min(c.y, a.p_pad - 1);
    }
  }
  __syncthreads();
  const int pg0 = s_pages[0];
  const int np = s_pages[1] - pg0 + 1;
  const bool staged = np <= kStagePages;
  if (staged && (int)threadIdx.x <= np) {
    const int p = pg0 + threadIdx.x;
    const int32_t rs = __ldg(a.prs + p);  // prs holds p_pad + 1 entries
    if ((int)threadIdx.x < np) {
      const int32_t kind = __ldg(a.page_kind + p);
      const int32_t aux = __ldg(a.aux + p);
      const long long base = __ldg(a.src_base + p);
      s_kind[threadIdx.x] = kind;
      s_aux[threadIdx.x] = aux;
      s_base[threadIdx.x] = base;
    }
    s_prs[threadIdx.x] = rs;
  }
  __syncthreads();
  const Pages pt = staged ? Pages{s_kind, s_prs, s_aux, s_base, np}
                          : Pages{a.page_kind + pg0, a.prs + pg0, a.aux + pg0,
                                  a.src_base + pg0, np};

  // the thread's rows: page, source index, and the first level of loads
  const long long r0 = begin + (long long)threadIdx.x * kItems;
  int pg = scan::count_le(pt.row_start + 1, pt.n - 1, r0);  // in [0, np)
  long long src[kItems];
  bool dict[kItems];
  long long base[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = r0 + k;
    while (pg < pt.n - 1 && pt.row_start[pg + 1] <= i) ++pg;
    src[k] = (long long)pt.aux[pg] + (i - (long long)pt.row_start[pg]);
    dict[k] = pt.kind[pg] == 1;
    base[k] = pt.src_base[pg];
  }
  long long key[kItems], p1[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    key[k] = 0;
    p1[k] = 0;
    if (r0 + k > last) continue;
    if (dict[k]) {
      const long long j = clampll(src[k], 0, a.d_pad - 1);
      key[k] = j < a.d ? (long long)__ldg(a.idx_all + j) : 0;
    } else {
      const long long e = clampll(src[k], 0, a.e_pad - 2);
      key[k] = e < a.e ? (long long)__ldg(a.po32 + e) : 0;
      p1[k] = e + 1 < a.e ? (long long)__ldg(a.po32 + e + 1) : 0;
    }
  }
  scan::SegPair<U> items[kItems];
  long long start[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    long long len = 0;
    start[k] = 0;
    if (r0 + k <= last) {
      if (dict[k]) {
        const long long kk = clampll(key[k], 0, a.doff_pad - 2);
        const long long lst = a.n_doff - 1;
        start[k] = __ldg(a.doff + (kk < lst ? kk : lst));
        len = __ldg(a.doff + (kk + 1 < lst ? kk + 1 : lst)) - start[k];
      } else {
        start[k] = key[k] + base[k];
        len = p1[k] - key[k];
      }
    }
    items[k].v = (U)(len > 0 ? len : 0);
    items[k].f = 0;
  }
  long long len_first = (long long)items[0].v;
  scan::seg_tile_scan<U, kThreads, kItems>(scan_temp, items, d, tile, false);

  // the rows' sources and output offsets (rows past the last have length
  // 0: their offsets are the tile's end)
  long long prev = (long long)items[0].v - len_first;
  long long dmin = LLONG_MAX, dmax = LLONG_MIN;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int row = threadIdx.x * kItems + k;
    s_start[row] = start[k];
    s_off[row] = prev;
    if ((long long)items[k].v != prev) {
      dmin = min(dmin, start[k] - prev);
      dmax = max(dmax, start[k] - prev);
    }
    prev = (long long)items[k].v;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    dmin = min(dmin, __shfl_xor_sync(0xffffffffu, dmin, o));
    dmax = max(dmax, __shfl_xor_sync(0xffffffffu, dmax, o));
  }
  if ((threadIdx.x & 31) == 0 && dmin <= dmax) {
    atomicMin(&s_dmin, dmin);
    atomicMax(&s_dmax, dmax);
  }
  if (threadIdx.x == kThreads - 1) s_off[kTile] = prev;
  if (tile == 0 && threadIdx.x == 0) offsets[0] = 0;
  __syncthreads();
  // (8-byte stores from the blocked items would leave each lane's four in
  // other sectors than its neighbours')
  for (int row = threadIdx.x; row < kTile && begin + row <= last; row += kThreads)
    offsets[begin + row + 1] = s_off[row + 1];

  // the copy: aligned 16-byte chunks of data over [lo_t, hi_t)
  const long long lo_t = s_off[0];
  const long long hi_t = min(s_off[kTile], data_bytes);
  // one piece: every row with bytes has one (source - output), so each
  // chunk's source is known without a search (a tile of one PLAIN page's
  // rows)
  const bool one_piece = s_dmin == s_dmax;
  if (hi_t <= lo_t) return;
  const long long c_first = lo_t >> 4, c_last = (hi_t - 1) >> 4;
  for (long long ch = c_first + threadIdx.x; ch <= c_last; ch += kThreads) {
    const long long cb = ch << 4;
    const long long lo = max(cb, lo_t), hi = min(cb + 16, hi_t);
    Chunk o;
    if (one_piece) {
      put_piece(a, o, (int)(lo - cb), (int)(hi - cb), cb + s_dmin);
    } else {
      int r = scan::count_le(s_off, kTile, lo) - 1;  // the row holding byte lo
      long long x = lo;
      while (true) {
        // a piece: rows from r on whose sources continue one another
        const long long delta = s_start[r] - s_off[r];  // source = output + delta
        long long end = s_off[r + 1];
        while (end < hi) {
          int n = r + 1;
          while (s_off[n + 1] <= end) ++n;  // past empty rows
          if (s_start[n] - s_off[n] != delta) break;
          r = n;
          end = s_off[r + 1];
        }
        const long long y = min(end, hi);
        put_piece(a, o, (int)(x - cb), (int)(y - cb), cb + delta);
        if (y >= hi) break;
        x = y;
        ++r;
        while (s_off[r + 1] <= x) ++r;
      }
    }
    if (lo == cb && hi == cb + 16) {
      *reinterpret_cast<ulonglong2*>(data + cb) = make_ulonglong2(o.lo, o.hi);
    } else {
      for (long long b = lo; b < hi; ++b) data[b] = o.byte((int)(b - cb));
    }
  }
}

}  // namespace

// 64-bit words of tile descriptors a merge of `n_rows` rows needs.
extern "C" int pqt_merge_bytes_scratch_words(long long n_rows) {
  return (int)scan::seg_scratch_words((n_rows + kTile - 1) / kTile);
}

// `data` and `scratch` must be 16-byte aligned; `scratch` holds
// pqt_merge_bytes_scratch_words 64-bit words (zeroed here, on the stream,
// before the launch).
extern "C" int pqt_merge_mixed_bytes(
    const void* idx_all, long long d, long long d_pad, const void* doff,
    long long n_doff, long long doff_pad, const void* pool, long long n_pool,
    const void* po32, long long e, long long e_pad, const void* page_kind,
    const void* prs, const void* aux, const void* src_base, int p_pad,
    long long n_rows, long long data_bytes, void* data, void* offsets,
    void* scratch, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  long long* off = (long long*)offsets;
  if (n_rows <= 0) return (int)cudaMemsetAsync(off, 0, sizeof(long long), s);
  if (p_pad <= 0 || n_pool <= 0 || (uintptr_t)data % 16 != 0 || (uintptr_t)scratch % 16 != 0)
    return (int)cudaErrorInvalidValue;
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
  a.pool_words = (uintptr_t)pool % 4 == 0;
  const long long ntiles = (n_rows + kTile - 1) / kTile;
  auto* sw = (unsigned long long*)scratch;
  int rc = (int)cudaMemsetAsync(sw, 0, scan::seg_scratch_words(ntiles) * 8, s);
  if (rc) return rc;
  merge<<<(unsigned)ntiles, kThreads, 0, s>>>(a, data_bytes, (uint8_t*)data, off,
                                              scan::SegTiles{sw, ntiles});
  return (int)cudaGetLastError();
}
