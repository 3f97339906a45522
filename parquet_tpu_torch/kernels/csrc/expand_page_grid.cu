// Page-grid expansion: a padded (P, W) grid of hybrid RLE/bit-packed index
// pages expanded to (P, n_out) indices and gathered from a dictionary.
//
// Replaces parquet_tpu/parallel/mesh.py:_expand_one_page, vmapped over a
// device's pages in sharded_decode_step, and the dictionary gather after it
// (`dict_dev[idx]`). Per output i of page p:
//   r      = (number of starts[p, :] <= i) - 1, clipped to [0, R-1] (the
//            grid pads starts with n_out + 1, and a padding page is all
//            zeros, so every row is non-decreasing);
//   bitpos = bit_starts[p, r] + (i - starts[p, r]) * width, in int32 with
//            wrap-around, as the JAX program computes it;
//   the two words at w0 = bitpos >> 5 and min(w0 + 1, W - 1), each index
//            wrapped once if negative and clamped into [0, W-1], as XLA's
//            gather does;
//   idx    = values[p, r] where is_rle[p, r] == 1, else the bits masked to
//            width (all ones at 32, none at 0);
//   out    = dictionary[clamp(int32(idx), 0, D-1)]: XLA gathers with the
//            uint32 index read as int32 and clamps (no wrap of negatives).
// Positions past a page's real count get exactly what the JAX program
// computes there. Floats travel as their 32/64-bit patterns.
//
// One kernel, the width a template parameter (shifts and masks are
// constants). A block takes a tile of kTile consecutive outputs of one
// page (the page from one 32-bit divide of the block index), a thread
// kItems of them, as expand_hybrid.cu does:
//   1. a page's run table of at most kStageRuns entries is staged whole in
//      shared memory; of a longer one, warp 0 first finds the runs of the
//      tile's first and last outputs with scan.cuh's 32-ary warp search and
//      the block stages that range (a tile over more runs reads the range
//      in global memory);
//   2. each thread finds its first output's run in the range by a binary
//      search and walks forward. Where its outputs lie in one run and need
//      none of the wrap-arounds and clamps above (an RLE run; a bit-packed
//      one whose bit positions stay in [0, 2^31) with every word below
//      W - 1), an RLE run is a broadcast and a bit-packed one loads the
//      payload words its outputs span once and funnel-shifts them
//      (hybrid.cuh's unpack_run). Every other output runs the exact
//      per-output path: no 64-bit divide and no search an output on either;
//   3. the dictionary is gathered through L1 (4,096 doubles, 32 KB, on the
//      main path), and a warp's outputs are staged in shared memory and
//      stored as 32 consecutive 16-byte vectors, marked evict-first
//      (element by element where the page's row is off 16 bytes or at its
//      end). Evict-first stores ran 5 % faster at the main shape and 19 %
//      on a grid of many runs; 16-byte vectors beat 8-byte stores, and a
//      swizzle of the staged vectors (a thread's vectors are 64 B apart)
//      gained nothing (PERF.md §6).
//
// Bound on an H100: memory, P * n_out * E bytes written plus the grid's
// words and run tables read once (the dictionary stays in L2). The design
// reads beyond it a tile's staged run range and the payload words a thread
// shares with its neighbours.

#include <climits>
#include <utility>

#include "hybrid.cuh"
#include "scan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;                 // outputs a thread: device_ops.PAGE_GRID_ITEMS
constexpr int kTile = kThreads * kItems;  // device_ops.PAGE_GRID_TILE
constexpr int kStageRuns = 128;           // device_ops.PAGE_GRID_STAGE_RUNS
static_assert(kStageRuns <= kThreads, "one staged run a thread");

// A range of a page's run tables: staged in shared memory or in place.
struct Runs {
  const int32_t* is_rle;
  const int32_t* starts;
  const uint32_t* value;
  const int32_t* bit_starts;
  int n;
};

__device__ __forceinline__ long long wrap_clamp(int j, int len) {
  long long k = j < 0 ? (long long)j + len : (long long)j;
  return k < 0 ? 0 : (k >= len ? len - 1 : k);
}

// Output i of run j, every wrap-around and clamp of the JAX program kept.
template <int W>
__device__ __forceinline__ uint32_t exact_index(const Runs& t, int j, int i, const uint32_t* row,
                                                int nw) {
  if (t.is_rle[j] == 1) return t.value[j];
  const uint32_t within = (uint32_t)i - (uint32_t)t.starts[j];
  const int bitpos = (int)((uint32_t)t.bit_starts[j] + within * (uint32_t)W);
  const int w0 = bitpos >> 5;
  const uint32_t s = (uint32_t)bitpos & 31u;
  const uint32_t lo = __ldg(row + wrap_clamp(w0, nw)) >> s;
  const int w1 = w0 + 1 < nw - 1 ? w0 + 1 : nw - 1;
  const uint32_t hi = s == 0 ? 0u : __ldg(row + wrap_clamp(w1, nw)) << ((32u - s) & 31u);
  return hybrid::low_bits<W>(lo | hi);
}

template <int W, typename T>
__global__ void __launch_bounds__(kThreads)
    expand(const uint32_t* __restrict__ words, int nw, const int32_t* __restrict__ starts,
           const int32_t* __restrict__ is_rle, const uint32_t* __restrict__ values,
           const int32_t* __restrict__ bit_starts, int R, const T* __restrict__ dict,
           long long D, int n_out, unsigned tiles_per_page, T* __restrict__ out) {
  constexpr int kWarpOut = 32 * kItems;           // outputs of a warp
  constexpr int kPerVec = 16 / (int)sizeof(T);    // outputs a 16-byte vector
  __shared__ int s_runs[2];
  __shared__ int32_t s_rle[kStageRuns];
  __shared__ int32_t s_st[kStageRuns];
  __shared__ uint32_t s_val[kStageRuns];
  __shared__ int32_t s_bs[kStageRuns];
  constexpr int kWarpVecs = kWarpOut / kPerVec;  // 16-byte vectors of a warp's outputs
  __shared__ uint4 s_out[kThreads / 32][kWarpVecs];
  const unsigned p = blockIdx.x / tiles_per_page;
  const int begin = (int)(blockIdx.x - p * tiles_per_page) * kTile;
  const int last = (int)min((long long)begin + kTile, (long long)n_out) - 1;
  const long long pr = (long long)p * R;
  const uint32_t* row = words + (long long)p * nw;

  int r0 = 0, nr = R;
  if (R > kStageRuns) {
    // a table too long to stage whole: the range of the tile's runs
    if (threadIdx.x < 32) {
      const int2 c = scan::warp_count_le2(starts + pr, R, begin, last);
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
    const long long r = pr + r0 + threadIdx.x;
    const int32_t rle = __ldg(is_rle + r);
    const int32_t st = __ldg(starts + r);
    const uint32_t val = __ldg(values + r);
    const int32_t bs = __ldg(bit_starts + r);
    s_rle[threadIdx.x] = rle;
    s_st[threadIdx.x] = st;
    s_val[threadIdx.x] = val;
    s_bs[threadIdx.x] = bs;
  }
  __syncthreads();
  const Runs t = staged ? Runs{s_rle, s_st, s_val, s_bs, nr}
                        : Runs{is_rle + pr + r0, starts + pr + r0, values + pr + r0,
                               bit_starts + pr + r0, nr};

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i0 = begin + (int)threadIdx.x * kItems;
  if (i0 <= last) {
    uint32_t idx[kItems];
    // entries before the range are <= begin, so the run is the range's
    // last start <= i (its first where none is)
    int j = max(scan::count_le(t.starts, t.n, i0) - 1, 0);
    int next = j + 1 < t.n ? t.starts[j + 1] : INT_MAX;
    const int i_end = i0 + kItems - 1;
    bool done = false;
    if (i_end <= last && i_end < next) {
      // one run holds all of the thread's outputs
      if (t.is_rle[j] == 1) {
        const uint32_t x = t.value[j];
#pragma unroll
        for (int k = 0; k < kItems; ++k) idx[k] = x;
        done = true;
      } else if constexpr (W == 0) {
#pragma unroll
        for (int k = 0; k < kItems; ++k) idx[k] = 0u;
        done = true;
      } else {
        const long long b0 = (long long)t.bit_starts[j] + ((long long)i0 - t.starts[j]) * W;
        const long long b_end = b0 + (long long)(kItems - 1) * W;
        if (b0 >= 0 && b_end <= INT_MAX && (b_end >> 5) + 1 <= nw - 1) {
          hybrid::unpack_run<W>(row, (unsigned)b0, idx);
          done = true;
        }
      }
    }
    if (!done) {
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        const int i = i0 + k;
        idx[k] = 0u;
        if (i > last) continue;
        while (i >= next) {
          ++j;
          next = j + 1 < t.n ? t.starts[j + 1] : INT_MAX;
        }
        idx[k] = exact_index<W>(t, j, i, row, nw);
      }
    }
    T v[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const long long d = (long long)(int32_t)idx[k];
      v[k] = __ldg(dict + (d < 0 ? 0 : (d >= D ? D - 1 : d)));
    }
#pragma unroll
    for (int q = 0; q < kItems / kPerVec; ++q) {
      uint4& slot = s_out[warp][lane * (kItems / kPerVec) + q];
      if constexpr (sizeof(T) == 4) {
        slot = make_uint4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
      } else {
        slot = make_uint4((uint32_t)v[2 * q], (uint32_t)(v[2 * q] >> 32),
                          (uint32_t)v[2 * q + 1], (uint32_t)(v[2 * q + 1] >> 32));
      }
    }
  }
  __syncwarp();
  // the warp's outputs, staged, out as consecutive 16-byte vectors
  const int w_first = begin + warp * kWarpOut;
  if (w_first > last) return;
  T* dst = out + (long long)p * n_out + w_first;
  if (w_first + kWarpOut - 1 <= last && (uintptr_t)dst % 16 == 0) {
    // evict-first: the outputs, several times the inputs, leave L2 to the
    // grid's words
#pragma unroll
    for (int q = lane; q < kWarpVecs; q += 32)
      __stcs(reinterpret_cast<uint4*>(dst) + q, s_out[warp][q]);
  } else {
    const T* staged = reinterpret_cast<const T*>(s_out[warp]);
    for (int e = lane; e < kWarpOut && w_first + e <= last; e += 32) dst[e] = staged[e];
  }
}

template <int W, typename T>
int launch(const uint32_t* words, int nw, const int32_t* starts, const int32_t* is_rle,
           const uint32_t* values, const int32_t* bit_starts, int R, const T* dict, long long D,
           int P, int n_out, T* out, cudaStream_t s) {
  const long long tiles = ((long long)n_out + kTile - 1) / kTile;
  // one launch takes at most 2^31 - 1 blocks: pages in chunks
  const long long chunk = 0x7FFFFFFFLL / tiles;
  for (long long p0 = 0; p0 < P; p0 += chunk) {
    const long long np = P - p0 < chunk ? P - p0 : chunk;
    expand<W, T><<<(unsigned)(np * tiles), kThreads, 0, s>>>(
        words + p0 * nw, nw, starts + p0 * R, is_rle + p0 * R, values + p0 * R,
        bit_starts + p0 * R, R, dict, D, n_out, (unsigned)tiles, out + p0 * n_out);
    const int rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  return 0;
}

template <typename T, int... Ws>
int dispatch(int width, const void* words, int nw, const void* starts, const void* is_rle,
             const void* values, const void* bit_starts, int R, const void* dict, long long D,
             int P, int n_out, void* out, cudaStream_t s, std::integer_sequence<int, Ws...>) {
  int rc = (int)cudaErrorInvalidValue;
  ((width == Ws ? (rc = launch<Ws, T>((const uint32_t*)words, nw, (const int32_t*)starts,
                                      (const int32_t*)is_rle, (const uint32_t*)values,
                                      (const int32_t*)bit_starts, R, (const T*)dict, D, P,
                                      n_out, (T*)out, s),
                   true)
                : false) ||
   ...);
  return rc;
}

}  // namespace

// words (P, W), starts / is_rle / values / bit_starts (P, R), all 4-byte and
// C-contiguous; dict of D elements of 4 (elem 4) or 8 bytes; out (P, n_out),
// 16-byte aligned.
extern "C" int pqt_expand_page_grid(const void* words, int W, const void* starts,
                                    const void* is_rle, const void* values,
                                    const void* bit_starts, int R, int width,
                                    const void* dict, long long D, int elem, int P, int n_out,
                                    void* out, void* stream) {
  if ((long long)P * n_out <= 0) return 0;
  if (W < 1 || R < 1 || width < 0 || width > 32 || (elem != 4 && elem != 8) ||
      (uintptr_t)out % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (elem == 4)
    return dispatch<uint32_t>(width, words, W, starts, is_rle, values, bit_starts, R, dict, D, P,
                              n_out, out, s, std::make_integer_sequence<int, 33>{});
  return dispatch<unsigned long long>(width, words, W, starts, is_rle, values, bit_starts, R,
                                      dict, D, P, n_out, out, s,
                                      std::make_integer_sequence<int, 33>{});
}
