// RLE / bit-packed hybrid expansion of a prescanned dictionary-index stream.
//
// Replaces parquet_tpu/kernels/device_ops.py:expand_hybrid_device (an XLA
// searchsorted + two-word gather + select chain). The input is the one packed
// upload that _HybridBatch.freeze builds (kernels/pipeline.py):
//
//   buf[0*run_pad : 1*run_pad]  is_rle     0/1
//   buf[1*run_pad : 2*run_pad]  out_start  exclusive cumsum of run counts (int32);
//                                          padding slots hold the sentinel n_pad+1
//   buf[2*run_pad : 3*run_pad]  rle_value  broadcast value of RLE runs
//   buf[3*run_pad : 4*run_pad]  bit_start  bit offset of the run's payload (int32)
//   buf[4*run_pad :]            packed payload words, plus one guard word
//
// Output i comes from run r, the largest with out_start[r] <= i: an RLE run
// gives rle_value[r]; a bit-packed run the `width` bits at bit_start[r] +
// (i - out_start[r]) * width of the payload words. width == 0 gives zeros
// (the XLA program returns zeros before the select, RLE runs included).
//
// One kernel, each block a tile of kTile consecutive outputs, each thread
// kItems of them, the width a template parameter (shifts and masks are
// constants):
//
//   1. a run table of at most kStageRuns entries (run_pad, the bucket of
//      the batch's run count) is staged whole in shared memory, one entry a
//      thread, by loads that go out as the block starts. Of a longer one,
//      warp 0 first finds the runs of the tile's first and last outputs in
//      out_start with a 32-ary warp search (scan.cuh warp_count_le2): 2-4
//      rounds of dependent loads for the whole tile, where the first
//      design ran a binary search of log2(run_pad) loads for every output;
//   2. the block stages the four run tables over that range. A tile
//      spanning more than kStageRuns runs (runs shorter than kTile /
//      kStageRuns values on average: 8-value runs of a width-1 level stream)
//      reads the same range of the tables in global memory instead;
//   3. each thread finds its first output's run in that range by a binary
//      search and walks forward. When its kItems outputs lie in one run (the
//      common case) an RLE run is a broadcast, and a bit-packed one loads
//      the payload words its outputs span once (at most
//      (kItems - 1) * width / 32 + 3 of them, each load independent), funnel-
//      shifts them to the first output's bit and takes every output at a
//      constant offset (hybrid.cuh, shared with expand_page_grid.cu); otherwise each output finds its run by the walk and
//      reads its two words;
//   4. one 16-byte store a thread; the tail past `total` is stored one
//      output at a time.
//
// 8 outputs a thread (2,048 a tile) measured 1.3x slower at 2^20 outputs of
// width 12 on an H100, and 5 % faster at 8 M: fewer tiles hide less of each
// tile's chain of round trips (PERF.md).
//
// Bound on an H100: memory. Bytes the function must move: the run tables
// (16 B a run), the packed payload (width / 8 bytes a bit-packed output) and
// the 4-byte outputs: at 2^20 outputs of width 12 about 5.8 MB, 1.7 us at
// 3.35 TB/s (measured about 3.7 us on an H100 80GB HBM3 at 700 W, where
// the first design took 7.7; PERF.md §6). The design reads beyond it the padding entries of a table
// staged whole (each block reads the whole table), the search's samples
// (2 x 32 entries a round and tile) and the payload words a thread shares
// with its neighbours. Positions are 32-bit: the batches keep their payload
// below 2^31 bits (device_ops.MAX_DEVICE_BATCH_BITS) and total below 2^31.

#include <climits>
#include <utility>

#include "hybrid.cuh"
#include "scan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;  // device_ops.HYBRID_TILE
constexpr int kStageRuns = 128;           // device_ops.HYBRID_STAGE_RUNS
static_assert(kStageRuns <= kThreads, "one staged run a thread");
static_assert(kItems % 4 == 0, "outputs stored 4 at a time");

// A range of the run tables: staged in shared memory or in place.
struct Runs {
  const uint32_t* is_rle;
  const int32_t* out_start;
  const uint32_t* value;
  const int32_t* bit_start;
  int n;
};

template <int W>
__global__ void __launch_bounds__(kThreads)
    expand(const uint32_t* __restrict__ buf, int run_pad, int total,
           int32_t* __restrict__ out) {
  __shared__ int s_runs[2];
  __shared__ uint32_t s_rle[kStageRuns];
  __shared__ int32_t s_os[kStageRuns];
  __shared__ uint32_t s_val[kStageRuns];
  __shared__ int32_t s_bs[kStageRuns];
  const int begin = blockIdx.x * kTile;
  const int last = (int)min((long long)begin + kTile, (long long)total) - 1;
  const int i0 = begin + (int)threadIdx.x * kItems;
  uint32_t v[kItems];

  if constexpr (W == 0) {
#pragma unroll
    for (int k = 0; k < kItems; ++k) v[k] = 0u;
  } else {
    const int32_t* out_start = reinterpret_cast<const int32_t*>(buf + run_pad);
    int r0 = 0, nr = run_pad;
    if (run_pad > kStageRuns) {
      // a table too long to stage whole: the range of the tile's runs
      if (threadIdx.x < 32) {
        const int2 c = scan::warp_count_le2(out_start, run_pad, begin, last);
        // out_start[0] == 0, so each count is at least 1
        if (threadIdx.x == 0) {
          s_runs[0] = max(c.x - 1, 0);
          s_runs[1] = max(c.y - 1, 0);
        }
      }
      __syncthreads();
      r0 = s_runs[0];
      nr = s_runs[1] - r0 + 1;
    }
    const bool staged = nr <= kStageRuns;
    if (staged && (int)threadIdx.x < nr) {
      const int r = r0 + threadIdx.x;
      const uint32_t rle = __ldg(buf + r);
      const int32_t os = __ldg(out_start + r);
      const uint32_t val = __ldg(buf + 2 * run_pad + r);
      const int32_t bs = __ldg(reinterpret_cast<const int32_t*>(buf + 3 * run_pad) + r);
      s_rle[threadIdx.x] = rle;
      s_os[threadIdx.x] = os;
      s_val[threadIdx.x] = val;
      s_bs[threadIdx.x] = bs;
    }
    __syncthreads();
    if (i0 > last) return;
    Runs t;
    if (staged) {
      t = Runs{s_rle, s_os, s_val, s_bs, nr};
    } else {
      t = Runs{buf + r0, out_start + r0, buf + 2 * run_pad + r0,
               reinterpret_cast<const int32_t*>(buf + 3 * run_pad) + r0, nr};
    }
    const uint32_t* words = buf + 4 * (long long)run_pad;

    int j = scan::count_le(t.out_start, t.n, i0) - 1;  // >= 0: out_start[r0] <= begin
    int next = j + 1 < t.n ? t.out_start[j + 1] : INT_MAX;
    const int i_end = i0 + kItems - 1;
    if (i_end <= last && i_end < next) {
      // one run holds all of the thread's outputs
      if (t.is_rle[j] != 0u) {
        const uint32_t x = t.value[j];
#pragma unroll
        for (int k = 0; k < kItems; ++k) v[k] = x;
      } else {
        hybrid::unpack_run<W>(words, (unsigned)t.bit_start[j] + (unsigned)(i0 - t.out_start[j]) * W, v);
      }
    } else {
      bool rle = t.is_rle[j] != 0u;
      uint32_t x = t.value[j];
      unsigned bit0 = (unsigned)t.bit_start[j] - (unsigned)t.out_start[j] * W;  // mod 2^32
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        const int i = i0 + k;
        v[k] = 0u;
        if (i > last) continue;
        if (i >= next) {
          do {
            ++j;
            next = j + 1 < t.n ? t.out_start[j + 1] : INT_MAX;
          } while (i >= next);
          rle = t.is_rle[j] != 0u;
          x = t.value[j];
          bit0 = (unsigned)t.bit_start[j] - (unsigned)t.out_start[j] * W;
        }
        if (rle) {
          v[k] = x;
        } else {
          const unsigned pos = bit0 + (unsigned)i * W;
          v[k] = hybrid::low_bits<W>(
              __funnelshift_r(__ldg(words + (pos >> 5)), __ldg(words + (pos >> 5) + 1), pos & 31));
        }
      }
    }
  }
  if (i0 > last) return;
  if (i0 + kItems - 1 <= last) {
    uint4* dst = reinterpret_cast<uint4*>(out + i0);
#pragma unroll
    for (int q = 0; q < kItems / 4; ++q)
      dst[q] = make_uint4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      if (i0 + k <= last) out[i0 + k] = (int32_t)v[k];
  }
}

template <int W>
int launch(const uint32_t* buf, int run_pad, int total, int32_t* out, cudaStream_t s) {
  const int blocks = (int)(((long long)total + kTile - 1) / kTile);
  expand<W><<<blocks, kThreads, 0, s>>>(buf, run_pad, total, out);
  return (int)cudaGetLastError();
}

template <int... Ws>
int dispatch(int width, const uint32_t* buf, int run_pad, int total, int32_t* out,
             cudaStream_t s, std::integer_sequence<int, Ws...>) {
  int rc = (int)cudaErrorInvalidValue;
  ((width == Ws ? (rc = launch<Ws>(buf, run_pad, total, out, s), true) : false) || ...);
  return rc;
}

}  // namespace

// `out` must be 16-byte aligned.
extern "C" int pqt_expand_hybrid(const void* buf, int run_pad, int width,
                                 int total, void* out, void* stream) {
  if (total <= 0) return 0;
  if (run_pad <= 0 || width < 0 || width > 32 || (uintptr_t)out % 16 != 0)
    return (int)cudaErrorInvalidValue;
  return dispatch(width, (const uint32_t*)buf, run_pad, total, (int32_t*)out,
                  (cudaStream_t)stream, std::make_integer_sequence<int, 33>{});
}
