// Record starts of a repetition-level stream: which record each level entry
// belongs to.
//
// Replaces parquet_tpu/kernels/device_ops.py:record_starts_device (under
// XLA: `cumsum(rep == 0) - 1` and a sum). An entry starts a record iff its
// repetition level is 0, so
//
//   row_of[i] = (number of j <= i with rep[j] == 0) - 1
//
// which is -1 for leading entries that start no record, and n_rows is the
// count of starts (int64, the dtype of the JAX program's count under x64).
//
// One pass of scan.cuh's vector scan (run1) over the start flags, in tiles
// of kThreads x kItems entries, after a memset of its look-back
// descriptors: each block counts its tile's starts, looks back over the
// earlier tiles' counts for its prefix, and writes row_of; the thread
// holding the last entry writes n_rows. Entries move as 16-byte vectors
// (where rep and row_of are 16-byte aligned), 32 consecutive ones a warp
// access.
//
// Bound on an H100: memory. Bytes: rep read once and row_of written once
// (8 B per entry), which is all the kernel moves beyond 16 B of descriptor
// a tile. The three-pass scan it replaced moved 16 B per entry and ran one
// block over every tile sum; a two-launch scan (tile sums, then a rescan)
// read rep twice and lost to this one pass (PERF.md §6).

#include "scan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 32;  // kThreads * kItems: device_ops.RECORD_STARTS_TILE

struct StartFlags {
  const int32_t* rep;
  long long n;
  bool vec;  // rep is 16-byte aligned
  __device__ void operator()(long long first, int32_t (&f)[4]) const {
    if (vec && first + 4 <= n) {
      const int4 r = *reinterpret_cast<const int4*>(rep + first);
      f[0] = r.x == 0;
      f[1] = r.y == 0;
      f[2] = r.z == 0;
      f[3] = r.w == 0;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) f[k] = first + k < n && rep[first + k] == 0;
    }
  }
};

struct RowOf {
  int32_t* row_of;
  long long* n_rows;
  long long n;
  bool vec;  // row_of is 16-byte aligned
  __device__ void operator()(long long first, const int32_t (&incl)[4],
                             const int32_t (&)[4]) const {
    if (first >= n) return;
    if (vec && first + 4 <= n) {
      *reinterpret_cast<int4*>(row_of + first) =
          make_int4(incl[0] - 1, incl[1] - 1, incl[2] - 1, incl[3] - 1);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (first + k < n) row_of[first + k] = incl[k] - 1;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (first + k == n - 1) *n_rows = (long long)incl[k];
  }
};

inline bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

}  // namespace

// descriptors: 2 + 2 * ceil(n / (kThreads * kItems)) 64-bit words.
extern "C" int pqt_record_starts(const void* rep, long long n, void* row_of,
                                 void* n_rows, void* descriptors, void* stream) {
  return scan::run1<int32_t, kThreads, kItems, 4>(
      StartFlags{(const int32_t*)rep, n, aligned16(rep)},
      RowOf{(int32_t*)row_of, (long long*)n_rows, n, aligned16(row_of)}, n,
      (unsigned long long*)descriptors, (cudaStream_t)stream);
}
