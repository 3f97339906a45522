// The run plan of the RLE/bit-packed hybrid encode: which values go into RLE
// runs, and the rest compacted in order for the bit-pack.
//
// Replaces parquet_tpu/kernels/device_ops.py:rle_hybrid_encode_device (under
// XLA: a boundary compare, cumsum, segment scatter-min/max of run extents,
// the 8-aligned window arithmetic, a cumsum and scatter-max compaction, then
// bitpack_encode_device). Its policy is ops/rle_hybrid.encode_hybrid's: a run
// of equal values [start, end) yields the RLE window [(start + 7) & ~7,
// end & ~7) when the run has >= 8 values and the window >= 8; every other
// value is bit-packed. Two scan.cuh scans:
//
//   1. over the run-start flags (i == 0 or v[i] != v[i-1]): the epilogue
//      writes run_of[i] (the run's number), run_start[run] at a start and
//      run_end[run] at a run's last value. Each table entry has one writer.
//   2. over the keep flags: the load functor reads its run's extent,
//      decides in_rle[i] and rle_break[i] (the window's first value, which
//      keeps adjacent windows of different runs apart) and writes them; the
//      epilogue stores each kept value at its compacted position in bp
//      (zeroed first, so the tail pads the last group with zeros) and the
//      count n_bp.
//
// The wrapper then packs bp with bitpack_encode (bitpack_encode.cu), as the
// reference calls bitpack_encode_device.
//
// Bound on an H100: memory. Bytes: the values read (4 B; the neighbour
// compare hits cache), the two masks written (2 B) and bp written (4 B per
// value). The scans add their partial buffers and the run tables (about
// 24 B per value).

#include "scan.cuh"

namespace {

struct RunStart {
  const uint32_t* v;
  __device__ int32_t operator()(long long i) const {
    return (i == 0 || v[i] != v[i - 1]) ? 1 : 0;
  }
};

struct RunTables {
  const uint32_t* v;
  long long n;
  int32_t* run_of;
  int32_t* run_start;
  int32_t* run_end;
  __device__ void operator()(long long i, int32_t incl, int32_t) const {
    const int32_t r = incl - 1;
    run_of[i] = r;
    if (i == 0 || v[i] != v[i - 1]) run_start[r] = (int32_t)i;
    if (i == n - 1 || v[i + 1] != v[i]) run_end[r] = (int32_t)(i + 1);
  }
};

struct Keep {
  const int32_t* run_of;
  const int32_t* run_start;
  const int32_t* run_end;
  bool* in_rle;
  bool* rle_break;
  __device__ int32_t operator()(long long i) const {
    const int32_t r = run_of[i];
    const long long s = run_start[r], e = run_end[r];
    const long long rs = (s + 7) & ~7LL, re = e & ~7LL;
    const bool rle = e - s >= 8 && re - rs >= 8 && i >= rs && i < re;
    in_rle[i] = rle;
    rle_break[i] = rle && i == rs;
    return rle ? 0 : 1;
  }
};

struct Compact {
  const uint32_t* v;
  const bool* in_rle;
  long long n;
  uint32_t* bp;
  int32_t* n_bp;
  __device__ void operator()(long long i, int32_t incl, int32_t total) const {
    if (!in_rle[i]) bp[incl - 1] = v[i];
    if (i == n - 1) *n_bp = total;
  }
};

}  // namespace

// values: uint32[n]; in_rle, rle_break: bool[n]; bp: uint32[n]; n_bp:
// int32[1]; scratch: int32[4n] (run_of, run_start, run_end, partial);
// tile_sums: the scans' scratch.
extern "C" int pqt_rle_hybrid_plan(const void* values, long long n, void* in_rle,
                                   void* rle_break, void* bp, void* n_bp, void* scratch,
                                   void* tile_sums, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* v = (const uint32_t*)values;
  int32_t* run_of = (int32_t*)scratch;
  int32_t* run_start = run_of + n;
  int32_t* run_end = run_start + n;
  int32_t* partial = run_end + n;
  int rc = (int)cudaMemsetAsync(bp, 0, (size_t)n * sizeof(uint32_t), s);
  if (rc) return rc;
  rc = scan::run<int32_t>(RunStart{v}, RunTables{v, n, run_of, run_start, run_end}, n,
                          run_of, (int32_t*)tile_sums, s);
  if (rc) return rc;
  return scan::run<int32_t>(
      Keep{run_of, run_start, run_end, (bool*)in_rle, (bool*)rle_break},
      Compact{v, (const bool*)in_rle, n, (uint32_t*)bp, (int32_t*)n_bp}, n, partial,
      (int32_t*)tile_sums, s);
}
