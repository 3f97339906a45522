// ('tags', 'contains', x) at the list-slot level: a dense per-element
// equality mask lifted through one LIST leaf's level streams to rows.
//
// Replaces parquet_tpu/kernels/device_ops.py:list_contains_mask_device
// (under XLA: two cumsums, a clipped gather and a scatter-max). With
//
//   valid[i]       = dfl[i] == elem_def                 (a present element)
//   didx[i]        = clip(count(valid[:i + 1]) - 1, 0, nv - 1)
//   entry_match[i] = valid[i] && nv > 0 && dense_match[didx[i]]
//   row_of[i]      = count(rep[:i + 1] == 0) - 1
//
// the reference sets rows[clip(row_of[i], 0, n - 1)] |= entry_match[i] over
// a zeroed bool[n] and counts the record starts. Entries before the first
// record start (a stream that opens mid-record) clip into row 0, as there.
//
// A memset of the output, then scan.cuh's one-pass vector scan (run1, after
// its memset of the look-back descriptors) over int64 items that pack both
// counts, the record start flag in the high 32 bits and the element flag in
// the low 32 (both counts stay below 2^31, so the low half never carries),
// in tiles of kThreads x kItems entries, as list_layout.cu packs its two.
// The loader reads one 16-byte vector of rep and one of dfl a 4-entry vector
// (entry by entry where either is not 16-byte aligned). The epilogue gets
// each vector's inclusive sums and items, gathers the dense mask at each
// element entry and stores `true` into the row of each match. Only `true`
// is stored over the zeroed output, so a row whose entries span warps or
// tiles needs no atomic and no single writer; a warp's stores fall on
// consecutive rows. The thread holding entry n - 1 writes the count of
// record starts (int64, the reference's dtype under x64) from its
// inclusive sum.
//
// Bound on an H100: memory. Bytes: rep and dfl read once (8 B per entry),
// the dense mask once (1 B per element), rows written once (1 B per entry);
// beyond that 16 B of descriptor a tile. The three-pass scan it replaced
// wrote and read an 8-byte partial per entry, read rep and dfl twice and
// walked every tile sum in one block (PERF.md §6).

#include "scan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;  // kThreads * kItems: device_ops.LIST_CONTAINS_TILE

struct Flags {
  const int32_t* rep;
  const int32_t* dfl;
  long long n, elem_def;
  bool vec;  // rep and dfl are 16-byte aligned
  __device__ long long item(int32_t r, int32_t d) const {
    return ((long long)(r == 0) << 32) | (long long)((long long)d == elem_def);
  }
  __device__ void operator()(long long first, long long (&it)[4]) const {
    if (vec && first + 4 <= n) {
      const int4 r = *reinterpret_cast<const int4*>(rep + first);
      const int4 d = *reinterpret_cast<const int4*>(dfl + first);
      it[0] = item(r.x, d.x);
      it[1] = item(r.y, d.y);
      it[2] = item(r.z, d.z);
      it[3] = item(r.w, d.w);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        it[k] = first + k < n ? item(rep[first + k], dfl[first + k]) : 0;
    }
  }
};

__device__ __forceinline__ long long clip(long long x, long long hi) {
  return x < 0 ? 0 : (x > hi ? hi : x);
}

// The matching entries' rows (items past n are 0: no element).
struct Lift {
  const uint8_t* dense_match;
  long long nv, n;
  bool* rows;
  long long* n_rows;
  __device__ void operator()(long long first, const long long (&incl)[4],
                             const long long (&it)[4]) const {
    // the four gathers first: a store into rows could alias dense_match, so
    // loads after it would wait for it
    bool hit[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      hit[e] = nv > 0 && (it[e] & 1) &&
               dense_match[clip((incl[e] & 0xffffffffll) - 1, nv - 1)] != 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (first + e == n - 1) *n_rows = incl[e] >> 32;
      if (hit[e]) rows[clip((incl[e] >> 32) - 1, n - 1)] = true;
    }
  }
};

}  // namespace

// rep, dfl: int32[n]; dense_match: bool[nv]; rows: bool[n] (zeroed here);
// n_rows: int64[1]; descriptors: 2 + 2 * ceil(n / (kThreads * kItems))
// 64-bit words.
extern "C" int pqt_list_contains_mask(const void* rep, const void* dfl, long long n,
                                      const void* dense_match, long long nv,
                                      long long elem_def, void* rows, void* n_rows,
                                      void* descriptors, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  int rc = (int)cudaMemsetAsync(rows, 0, (size_t)n, s);
  if (rc) return rc;
  const Flags f{(const int32_t*)rep, (const int32_t*)dfl, n, elem_def,
                (uintptr_t)rep % 16 == 0 && (uintptr_t)dfl % 16 == 0};
  return scan::run1<long long, kThreads, kItems, 4>(
      f, Lift{(const uint8_t*)dense_match, nv, n, (bool*)rows, (long long*)n_rows}, n,
      (unsigned long long*)descriptors, s);
}
