// DELTA_BINARY_PACKED decode of a whole chunk from wire words, 32 and 64 bit.
//
// Replaces parquet_tpu/kernels/device_ops.py:delta_packed_decode_device (an
// XLA chain: two searchsorteds, a dynamic-width two-word gather, a wrapping
// cumsum and a per-page rebase). The inputs are the uploads that
// _DeltaBatch.freeze lays out (kernels/pipeline.py):
//
//   meta32  [widths(m) | bit_starts(m) | out_starts(m) | page_start(p)]
//           + for nbits=32: [mins(m) | page_first(p) | wire words]
//   wide    for nbits=64: [mins(m) | page_first(p) | wire words] as uint64
//
// Padding slots of out_starts and page_start hold the sentinel n_pad+1. The
// first value of each page sits in no miniblock (its out_starts are page
// start + 1 onward). In wrapping unsigned arithmetic, with d[i] the unpacked
// delta plus its block's min:
//
//   value[i] = page_first[p]                 at a page start i
//   value[i] = value[i - 1] + d[i]           elsewhere
//
// which is the segmented inclusive scan of the items (1, page_first[p]) at
// page starts and (0, d[i]) elsewhere (scan.cuh, SegOp). One kernel, each
// block one tile of kTile consecutive outputs, each thread kItems of them:
//
//   1. the first search round's loads: out_start and page_start sampled at
//      kFanout evenly spaced entries each (they depend only on the tables'
//      lengths, so they go out before the tile index is known); then the
//      tile's index from a counter (scan.cuh next_tile);
//   2. the samples at or below the tile's first and last outputs narrow
//      where the miniblocks and pages holding them lie to one sampling
//      stride each (64 entries for 2^16 miniblocks);
//   3. the window of miniblock descriptors (width, bit start, out start,
//      min) and of pages (start, first value) that holds both strides,
//      staged in shared memory, and the exact miniblocks and pages found
//      there (one thread a key). A window wider than kStageMb or
//      kStagePages (8-value miniblocks of more than 2^17 entries, pages
//      shorter than kTile / kStagePages) is searched and read in global
//      memory instead (block_count_le);
//   4. the tile's wire words, from its first miniblock's start to its last
//      value's end, staged by 16-byte loads in shared memory with a pad
//      word after every 32, so words a thread's stride apart fall in
//      different banks (a tile whose words do not fit reads them in global
//      memory);
//   5. each thread finds its first output's miniblock and page by a binary
//      search in the staged tables and walks forward for the rest (a thread
//      whose outputs lie in one miniblock of one page skips the walk),
//      unpacks w bits by funnel shifts over 32-bit words (two for a 32-bit
//      value, three for a 64-bit one) and adds the min;
//   6. the segmented scan of the tile (cub::BlockScan, raking) with a
//      decoupled look-back across tiles (scan.cuh seg_tile_scan): a tile
//      that holds a page start publishes its inclusive prefix at once, so
//      the look-back stops there;
//   7. one write of each output (16-byte stores in a full tile).
//
// Bound on an H100: memory. Bytes the function must move: 20 per miniblock
// (width, bit start, out start, 8-byte min), 12 per page (start, first
// value), the wire words, 8 (or 4) per output: 20 m + 12 p + wire + 8 n. The
// design reads beyond it: the first round's samples (2 x kFanout int32 a
// tile, the same for every tile), a staged window of up to two sampling
// strides more miniblocks than the tile holds, the words of a tile's first
// miniblock before the tile and of its last one after it, and 16 x (1 + t)
// bytes of tile descriptors for t tiles, zeroed before the launch. No
// scratch of n elements is written. Index and bit arithmetic is 32-bit. On
// an H100 each tile is a chain of dependent memory round trips (counter,
// staging, words, look-back) and its SM's issue slots are shared by four
// or five tiles: the kernel runs at about 5x its bound, the look-back and
// the per-output search and unpack taking most of it (PERF.md).
//
// Rules kept from the first version: a shift of 0 takes the words as they
// are and w == 64 masks nothing; the padding sentinels; a page's first value
// contributes no delta; total < 2^31. 64-bit scans keep the
// 256-thread __launch_bounds__ cap (a 1,024-thread 64-bit cub::BlockScan
// asked for more registers than an SM has).

#include <climits>

#include "scan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;  // device_ops.DELTA_TILE
constexpr int kWarps = kThreads / 32;
constexpr int kSearches = 4;
// the first search round samples each table at kFanout entries (kSamples a
// thread), so it narrows a table of m entries to ceil(m / kFanout)
constexpr int kSamples = 4;
constexpr int kFanout = kThreads * kSamples;
// the staged window of a tile: its miniblocks (kTile / 8 + 1 of 8 values,
// plus one a page break) and up to one sampling stride on each side (128
// for the 2^17 miniblocks of 2^20 values in 8-value miniblocks)
constexpr int kStageMb = kTile / 4 + 32;
constexpr int kStagePages = 64;
static_assert(kStagePages <= kThreads, "one staged page a thread");
// the tile's wire words: kTile values of up to 64 bits, the part of its first
// miniblock before the tile, and the funnel's guard words (a multiple of 4)
constexpr int kStageWords = kTile * 2 + 512;
static_assert(kStageWords % 4 == 0, "staged in 16-byte loads");
constexpr int kPaddedWords = kStageWords + kStageWords / 32;

template <typename U>
struct Tables {
  const uint32_t* width;
  const int32_t* bit_start;
  const int32_t* out_start;
  const int32_t* page_start;
  const U* mb_min;
  const U* page_first;
  const U* words;
  int m_pad;
  int p_pad;
};

// Word j of the wire words: staged in shared memory with one pad word after
// every 32 (kPadded: words a thread's stride apart then fall in different
// banks, whatever the bit width), or as uploaded.
template <bool kPadded>
__device__ __forceinline__ uint32_t word(const uint32_t* w32, unsigned j) {
  return kPadded ? w32[j + (j >> 5)] : w32[j];
}

// w bits at bit `pos` of the words, as a 32- or 64-bit value; past the last
// bit a value needs the words hold one more word (two for 64-bit values)
// for the funnel
template <typename U, bool kPadded>
__device__ __forceinline__ U unpack(const uint32_t* w32, unsigned pos, uint32_t w) {
  if (w == 0) return U(0);
  const unsigned q = pos >> 5, sh = pos & 31;
  const uint32_t b = word<kPadded>(w32, q + 1);
  const uint32_t lo = __funnelshift_r(word<kPadded>(w32, q), b, sh);
  if constexpr (sizeof(U) == 8) {
    const uint32_t hi = __funnelshift_r(b, word<kPadded>(w32, q + 2), sh);
    const unsigned long long v = ((unsigned long long)hi << 32) | lo;
    return w >= 64 ? v : (v & ((1ull << w) - 1ull));
  } else {
    return w >= 32 ? lo : (lo & ((1u << w) - 1u));
  }
}

// The number of entries of the sorted arr[k] that are <= key[k], known to
// lie in [lo[k], hi[k]], narrowed by the whole block until lo == hi: each
// round every thread samples one entry of each open range at stride
// ceil(span / kThreads), and the count of samples <= key narrows the range
// to one stride. Every thread passes the same arguments and gets the same
// counts (in lo).
__device__ __forceinline__ void block_count_le(const int32_t* const (&arr)[kSearches],
                                               const long long (&key)[kSearches],
                                               int (&lo)[kSearches], int (&hi)[kSearches],
                                               int (*votes)[kSearches][kWarps]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int round = 0;; ++round) {
    bool open = false;
#pragma unroll
    for (int k = 0; k < kSearches; ++k) open |= lo[k] < hi[k];
    if (!open) break;
    int(*v)[kWarps] = votes[round & 1];
    int step[kSearches];
#pragma unroll
    for (int k = 0; k < kSearches; ++k) {
      const int span = hi[k] - lo[k];
      step[k] = (span + kThreads - 1) / kThreads;
      bool pred = false;
      if (span > 0) {
        const long long j = lo[k] + (long long)(threadIdx.x + 1) * step[k] - 1;
        pred = j < hi[k] && (long long)__ldg(arr[k] + j) <= key[k];
      }
      const unsigned b = __ballot_sync(0xffffffffu, pred);
      if (lane == 0) v[k][warp] = __popc(b);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kSearches; ++k) {
      if (step[k] == 0) continue;
      int c = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) c += v[k][w];
      const int nlo = lo[k] + c * step[k];
      hi[k] = min(nlo + step[k] - 1, hi[k]);
      lo[k] = nlo;
    }
  }
}

// The items of the thread whose first output is i0: (1, page_first) at a
// page start, else (0, delta + min). The tables are the tile's narrowed
// miniblocks (mc) and pages (pc); w32 holds the wire words from bit pos0.
// A thread finds its first output's miniblock and page by a binary search
// and walks forward; one whose outputs lie in one miniblock of one page
// skips the walk and takes its masks once.
template <typename U, bool kPadded>
__device__ __forceinline__ void decode_items(const uint32_t* vw, const int32_t* vb,
                                             const int32_t* vo, const U* vm, int mc,
                                             const int32_t* vps, const U* vpf, int pc,
                                             const uint32_t* w32, unsigned pos0, unsigned i0,
                                             unsigned ulast,
                                             scan::SegPair<U> (&items)[kItems]) {
  int jm = scan::count_le(vo, mc, i0);  // the next miniblock's index
  int jp = scan::count_le(vps, pc, i0);  // the next page's index
  unsigned next_m = jm < mc ? (unsigned)vo[jm] : UINT_MAX;
  unsigned next_p = jp < pc ? (unsigned)vps[jp] : UINT_MAX;
  int m = max(jm - 1, 0);
  uint32_t w = vw[m];
  unsigned bit0 = (unsigned)vb[m] - pos0 - (unsigned)vo[m] * w;  // bit of output 0, mod 2^32
  U mn = vm[m];
  unsigned pstart = jp > 0 ? (unsigned)vps[jp - 1] : UINT_MAX;
  U pfirst = jp > 0 ? vpf[jp - 1] : U(0);

  const unsigned i_end = i0 + kItems - 1;
  if (jm > 0 && i_end <= ulast && i_end < next_m && i_end < next_p && i0 != pstart) {
    // the common case: one miniblock, no page start, one width: its masks
    // are taken once (measured about 1 % faster than unpack per output)
    if (w == 0) {
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        items[k].v = mn;
        items[k].f = 0;
      }
      return;
    }
    const uint32_t mlo = w >= 32 ? ~0u : (1u << w) - 1u;
    const uint32_t mhi = w >= 64 ? ~0u : w > 32 ? (1u << (w - 32)) - 1u : 0u;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const unsigned pos = bit0 + (i0 + k) * w, q = pos >> 5, sh = pos & 31;
      const uint32_t b = word<kPadded>(w32, q + 1);
      const uint32_t lo = __funnelshift_r(word<kPadded>(w32, q), b, sh) & mlo;
      if constexpr (sizeof(U) == 8) {
        const uint32_t hi = __funnelshift_r(b, word<kPadded>(w32, q + 2), sh) & mhi;
        items[k].v = (((unsigned long long)hi << 32) | lo) + mn;
      } else {
        items[k].v = lo + mn;
      }
      items[k].f = 0;
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const unsigned i = i0 + k;
    items[k].v = U(0);
    items[k].f = 0;
    if (i > ulast) continue;
    if (i >= next_p) {
      do {
        ++jp;
      } while (jp < pc && (unsigned)vps[jp] <= i);
      next_p = jp < pc ? (unsigned)vps[jp] : UINT_MAX;
      pstart = (unsigned)vps[jp - 1];
      pfirst = vpf[jp - 1];
    }
    if (i == pstart) {
      items[k].f = 1;
      items[k].v = pfirst;
      continue;
    }
    if (i >= next_m) {
      do {
        ++jm;
      } while (jm < mc && (unsigned)vo[jm] <= i);
      next_m = jm < mc ? (unsigned)vo[jm] : UINT_MAX;
      m = jm - 1;
      w = vw[m];
      bit0 = (unsigned)vb[m] - pos0 - (unsigned)vo[m] * w;
      mn = vm[m];
    }
    items[k].v = U(unpack<U, kPadded>(w32, bit0 + i * w, w) + mn);
  }
}

template <typename U>
__global__ void __launch_bounds__(kThreads)
    decode(Tables<U> t, int total, U* __restrict__ out, scan::SegTiles d) {
  __shared__ typename scan::SegBlockScan<U, kThreads>::TempStorage scan_temp;
  __shared__ int first_votes[kSearches][kWarps];
  __shared__ int votes[2][kSearches][kWarps];
  __shared__ unsigned int tile_slot;
  __shared__ uint32_t s_width[kStageMb];
  __shared__ int32_t s_bit[kStageMb];
  __shared__ int32_t s_out[kStageMb];
  __shared__ U s_min[kStageMb];
  __shared__ int32_t s_ps[kStagePages];
  __shared__ U s_pf[kStagePages];
  __shared__ uint32_t s_words[kPaddedWords];
  __shared__ int s_cnt[kSearches];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // The first search round samples out_start and page_start at kFanout
  // evenly spaced entries each. Its loads depend only on the tables'
  // lengths, so they go out before the tile index comes back.
  const int32_t* const tab[kSearches] = {t.out_start, t.out_start, t.page_start,
                                         t.page_start};
  const int len[kSearches] = {t.m_pad, t.m_pad, t.p_pad, t.p_pad};
  int smp[2][kSamples];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int step = (len[2 * a] + kFanout - 1) / kFanout;
#pragma unroll
    for (int q = 0; q < kSamples; ++q) {
      const long long j = (long long)(threadIdx.x * kSamples + q + 1) * step - 1;
      smp[a][q] = j < len[2 * a] ? __ldg(tab[2 * a] + j) : INT_MAX;
    }
  }
  const long long tile = scan::next_tile(d, &tile_slot);
  const long long begin = tile * kTile;
  const long long last = min(begin + kTile, (long long)total) - 1;
  const long long key[kSearches] = {begin, last, begin, last};

  // the samples <= each key: the count lies in [lo, hi], one stride wide
  int lo[kSearches], hi[kSearches];
#pragma unroll
  for (int k = 0; k < kSearches; ++k) {
    int c = 0;
#pragma unroll
    for (int q = 0; q < kSamples; ++q) c += (long long)smp[k / 2][q] <= key[k];
    c = __reduce_add_sync(0xffffffffu, c);
    if (lane == 0) first_votes[k][warp] = c;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kSearches; ++k) {
    int c = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) c += first_votes[k][w];
    const int step = (len[k] + kFanout - 1) / kFanout;
    lo[k] = c * step;
    hi[k] = min(lo[k] + step - 1, len[k]);
  }

  // the windows that hold both counts' ranges, staged when they fit: the
  // miniblocks and pages holding the tile's first and last outputs lie in
  // them
  const int ws_m = max(lo[0] - 1, 0), we_m = min(max(hi[1], ws_m + 1), t.m_pad);
  const int ws_p = max(lo[2] - 1, 0), we_p = min(max(hi[3], ws_p + 1), t.p_pad);
  const bool stage_m = we_m - ws_m <= kStageMb;
  const bool stage_p = we_p - ws_p <= kStagePages;
  // (a thread's loads all go out before its stores, so they wait on memory
  // once)
  if (stage_m) {
    constexpr int kRounds = (kStageMb + kThreads - 1) / kThreads;
    uint32_t w[kRounds];
    int32_t b[kRounds], o[kRounds];
    U mn[kRounds];
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int j = r * kThreads + threadIdx.x;
      if (j < we_m - ws_m) {
        w[r] = __ldg(t.width + ws_m + j);
        b[r] = __ldg(t.bit_start + ws_m + j);
        o[r] = __ldg(t.out_start + ws_m + j);
        mn[r] = __ldg(t.mb_min + ws_m + j);
      }
    }
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int j = r * kThreads + threadIdx.x;
      if (j < we_m - ws_m) {
        s_width[j] = w[r];
        s_bit[j] = b[r];
        s_out[j] = o[r];
        s_min[j] = mn[r];
      }
    }
  }
  if (stage_p && (int)threadIdx.x < we_p - ws_p) {
    const int32_t ps = __ldg(t.page_start + ws_p + threadIdx.x);
    const U pf = __ldg(t.page_first + ws_p + threadIdx.x);
    s_ps[threadIdx.x] = ps;
    s_pf[threadIdx.x] = pf;
  }
  // a window too wide: the exact counts by further rounds over the tables
  if (!stage_m || !stage_p) block_count_le(tab, key, lo, hi, votes);
  __syncthreads();
  // the exact counts in the staged windows, one thread a key
  if (threadIdx.x < kSearches) {
    const int k = threadIdx.x;
    const long long x = k & 1 ? last : begin;
    int c = k == 0 ? lo[0] : k == 1 ? lo[1] : k == 2 ? lo[2] : lo[3];
    if (k < 2 && stage_m) c = ws_m + scan::count_le(s_out, we_m - ws_m, x);
    if (k >= 2 && stage_p) c = ws_p + scan::count_le(s_ps, we_p - ws_p, x);
    s_cnt[k] = c;
  }
  __syncthreads();
  const int cnt[kSearches] = {s_cnt[0], s_cnt[1], s_cnt[2], s_cnt[3]};
  const int m0 = max(cnt[0] - 1, 0);
  const int mc = max(cnt[1] - 1, m0) - m0 + 1;
  const int p0 = max(cnt[2] - 1, 0);
  const int pc = max(cnt[3] - 1, p0) - p0 + 1;
  // the tile's miniblocks and pages: staged, or the same range of the tables
  const uint32_t* vw = stage_m ? s_width + (m0 - ws_m) : t.width + m0;
  const int32_t* vb = stage_m ? s_bit + (m0 - ws_m) : t.bit_start + m0;
  const int32_t* vo = stage_m ? s_out + (m0 - ws_m) : t.out_start + m0;
  const U* vm = stage_m ? s_min + (m0 - ws_m) : t.mb_min + m0;
  const int32_t* vps = stage_p ? s_ps + (p0 - ws_p) : t.page_start + p0;
  const U* vpf = stage_p ? s_pf + (p0 - ws_p) : t.page_first + p0;

  // The tile's wire words, from its first miniblock's start to its last
  // value's end, staged by coalesced loads when they fit. Outputs and bit
  // positions fit 32 bits (total < 2^31, bits < 2^31); positions below are
  // relative to the first staged word.
  const long long bit_lo = vb[0];
  const long long bit_hi =
      max((long long)vb[mc - 1] + (last - (long long)vo[mc - 1] + 1) * (long long)vw[mc - 1],
          bit_lo);
  // (from a 16-byte boundary: the words start at one, and 16-byte loads
  // take the whole ones, single loads the rest)
  const long long w_lo = (bit_lo >> 5) & ~3ll;
  const int nw = (int)(((bit_hi + 31) >> 5) + (sizeof(U) == 8 ? 2 : 1) - w_lo);
  const bool stage_w = nw <= kStageWords;
  const uint32_t* w32 = reinterpret_cast<const uint32_t*>(t.words) + w_lo;
  if (stage_w) {
    // a thread's 16-byte loads all go out before its stores
    constexpr int kRounds = (kStageWords / 4 + kThreads - 1) / kThreads;
    const uint4* src = reinterpret_cast<const uint4*>(w32);
    uint4 v[kRounds];
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int j = r * kThreads + threadIdx.x;
      if (j < nw / 4) v[r] = __ldg(src + j);
    }
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int j = 4 * (r * kThreads + threadIdx.x);
      if (j < nw - nw % 4) {
        uint32_t* dst = s_words + j + (j >> 5);  // j % 4 == 0: no pad inside
        dst[0] = v[r].x;
        dst[1] = v[r].y;
        dst[2] = v[r].z;
        dst[3] = v[r].w;
      }
    }
    const int tail = nw - nw % 4 + threadIdx.x;
    if (tail < nw) s_words[tail + (tail >> 5)] = __ldg(w32 + tail);
    __syncthreads();
  }
  const unsigned pos0 = (unsigned)(w_lo << 5);

  // this thread's outputs
  const unsigned i0 = (unsigned)begin + threadIdx.x * kItems;
  scan::SegPair<U> items[kItems];
  if (stage_w)
    decode_items<U, true>(vw, vb, vo, vm, mc, vps, vpf, pc, s_words, pos0, i0, (unsigned)last,
                          items);
  else
    decode_items<U, false>(vw, vb, vo, vm, mc, vps, vpf, pc, w32, pos0, i0, (unsigned)last,
                           items);

  // the tile's first output starts a page: nothing before it is needed
  const bool first_resets = (long long)vps[0] == begin;
  scan::seg_tile_scan<U, kThreads, kItems>(scan_temp, items, d, tile, first_resets);

  if (begin + kTile <= total) {
    if constexpr (sizeof(U) == 8) {
      ulonglong2* dst = reinterpret_cast<ulonglong2*>(out + i0);
#pragma unroll
      for (int q = 0; q < kItems / 2; ++q)
        dst[q] = make_ulonglong2(items[2 * q].v, items[2 * q + 1].v);
    } else {
      uint4* dst = reinterpret_cast<uint4*>(out + i0);
#pragma unroll
      for (int q = 0; q < kItems / 4; ++q)
        dst[q] = make_uint4(items[4 * q].v, items[4 * q + 1].v, items[4 * q + 2].v,
                            items[4 * q + 3].v);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      if (i0 + k <= last) out[i0 + k] = items[k].v;
  }
}

template <typename U>
int run(const Tables<U>& t, int total, U* out, unsigned long long* scratch,
        cudaStream_t stream) {
  const long long ntiles = ((long long)total + kTile - 1) / kTile;
  int rc = (int)cudaMemsetAsync(scratch, 0, scan::seg_scratch_words(ntiles) * 8, stream);
  if (rc) return rc;
  decode<U><<<(unsigned)ntiles, kThreads, 0, stream>>>(t, total, out,
                                                        scan::SegTiles{scratch, ntiles});
  return (int)cudaGetLastError();
}

}  // namespace

// 64-bit words of tile descriptors a decode of `total` outputs needs.
extern "C" int pqt_delta_scratch_words(int total) {
  return (int)scan::seg_scratch_words(((long long)total + kTile - 1) / kTile);
}

// `out` and `scratch` must be 16-byte aligned; `scratch` holds
// pqt_delta_scratch_words 64-bit words (zeroed here, on the stream, before
// the launch).
extern "C" int pqt_delta_packed_decode(const void* meta32_v, const void* wide_v,
                                       int nbits, int m_pad, int p_pad, int total,
                                       void* out, void* scratch, void* stream) {
  if (total <= 0) return 0;
  if (m_pad <= 0 || p_pad <= 0 || (uintptr_t)out % 16 != 0 || (uintptr_t)scratch % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const uint32_t* meta32 = (const uint32_t*)meta32_v;
  const cudaStream_t s = (cudaStream_t)stream;
  auto* sw = (unsigned long long*)scratch;
  if (nbits == 32) {
    Tables<uint32_t> t;
    t.width = meta32;
    t.bit_start = (const int32_t*)(meta32 + m_pad);
    t.out_start = (const int32_t*)(meta32 + 2 * m_pad);
    t.page_start = (const int32_t*)(meta32 + 3 * m_pad);
    t.mb_min = meta32 + 3 * m_pad + p_pad;
    t.page_first = meta32 + 4 * m_pad + p_pad;
    t.words = meta32 + 4 * m_pad + 2 * p_pad;
    t.m_pad = m_pad;
    t.p_pad = p_pad;
    return run<uint32_t>(t, total, (uint32_t*)out, sw, s);
  }
  if (nbits == 64) {
    const unsigned long long* wide = (const unsigned long long*)wide_v;
    Tables<unsigned long long> t;
    t.width = meta32;
    t.bit_start = (const int32_t*)(meta32 + m_pad);
    t.out_start = (const int32_t*)(meta32 + 2 * m_pad);
    t.page_start = (const int32_t*)(meta32 + 3 * m_pad);
    t.mb_min = wide;
    t.page_first = wide + m_pad;
    t.words = wide + m_pad + p_pad;
    t.m_pad = m_pad;
    t.p_pad = p_pad;
    return run<unsigned long long>(t, total, (unsigned long long*)out, sw, s);
  }
  return (int)cudaErrorInvalidValue;
}
