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
// count of starts. One scan.cuh scan over the start flags, with row_of
// itself as the scan's partial buffer; the epilogue subtracts 1 in place,
// and thread 0 writes n_rows (int64, the dtype of the JAX program's count
// under x64).
//
// Bound on an H100: memory. Bytes: rep read once and row_of written once
// (8 B per entry); the scan reads and writes row_of once more between its
// passes (8 B per entry), and reads rep in pass 1 only.

#include "scan.cuh"

namespace {

struct StartFlag {
  const int32_t* rep;
  __device__ int32_t operator()(long long i) const { return rep[i] == 0 ? 1 : 0; }
};

struct RowOf {
  int32_t* row_of;
  long long* n_rows;
  __device__ void operator()(long long i, int32_t incl, int32_t total) const {
    row_of[i] = incl - 1;
    if (i == 0) *n_rows = (long long)total;
  }
};

}  // namespace

// Elements per tile of scan.cuh: wrappers size each scan's tile_sums
// scratch with it (num_tiles + 1 entries).
extern "C" int pqt_scan_tile() { return scan::kTile; }

extern "C" int pqt_record_starts(const void* rep, long long n, void* row_of,
                                 void* n_rows, void* tile_sums, void* stream) {
  return scan::run<int32_t>(StartFlag{(const int32_t*)rep},
                            RowOf{(int32_t*)row_of, (long long*)n_rows}, n,
                            (int32_t*)row_of, (int32_t*)tile_sums,
                            (cudaStream_t)stream);
}
