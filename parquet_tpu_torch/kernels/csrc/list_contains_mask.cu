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
// One scan.cuh scan over int64 items that pack both counts, the record
// start flag in the high 32 bits and the element flag in the low 32 (both
// counts stay below 2^31, so the low half never carries), as list_layout.cu
// packs its two. The output is zeroed on the stream first; the epilogue
// stores `true` into rows[row] for every matching entry. All writers of one
// row store the same value, so no atomic is needed. The last thread writes
// the count of record starts (int64, the reference's dtype under x64).
//
// Bound on an H100: memory. Bytes: rep and dfl read once (8 B per entry),
// the dense mask once (1 B per element), rows written once (1 B per entry);
// beyond that the scan writes and reads its 8-byte partial per entry, and
// the epilogue reads rep and dfl again.

#include "scan.cuh"

namespace {

struct Flags {
  const int32_t* rep;
  const int32_t* dfl;
  long long elem_def;
  __device__ bool start(long long i) const { return rep[i] == 0; }
  __device__ bool elem(long long i) const { return (long long)dfl[i] == elem_def; }
  __device__ long long operator()(long long i) const {
    return ((long long)start(i) << 32) | (long long)elem(i);
  }
};

struct Lift {
  Flags f;
  long long n;
  const bool* dense_match;
  long long nv;
  bool* rows;
  long long* n_rows;
  __device__ void operator()(long long i, long long incl, long long total) const {
    if (nv > 0 && f.elem(i)) {
      long long k = (incl & 0xffffffffll) - 1;
      k = k < 0 ? 0 : (k >= nv ? nv - 1 : k);
      if (dense_match[k]) {
        long long r = (incl >> 32) - 1;
        r = r < 0 ? 0 : (r >= n ? n - 1 : r);
        rows[r] = true;
      }
    }
    if (i == n - 1) *n_rows = total >> 32;
  }
};

}  // namespace

// rep, dfl: int32[n]; dense_match: bool[nv]; rows: bool[n] (zeroed here);
// n_rows: int64[1]; partial: int64[n] and tile_sums: the scan's scratch.
extern "C" int pqt_list_contains_mask(const void* rep, const void* dfl, long long n,
                                      const void* dense_match, long long nv,
                                      long long elem_def, void* rows, void* n_rows,
                                      void* partial, void* tile_sums, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  int rc = (int)cudaMemsetAsync(rows, 0, (size_t)n, s);
  if (rc) return rc;
  const Flags f{(const int32_t*)rep, (const int32_t*)dfl, elem_def};
  return scan::run<long long>(
      f, Lift{f, n, (const bool*)dense_match, nv, (bool*)rows, (long long*)n_rows}, n,
      (long long*)partial, (long long*)tile_sums, s);
}
