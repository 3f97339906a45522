// Compaction of rows under a mask: values[mask] into a buffer of out_pad
// rows, in two entry points.
//
// Replaces parquet_tpu/kernels/device_ops.py:mask_take_device (under XLA:
// a cumsum of the mask, a scatter-max of the kept positions' indices into
// src[out_pad + 1] and a gather values[src]) and the per-leaf
// `a[sel][:kept]` of parquet_tpu/core/reader.py:_device_filter_rows:
//
//   pqt_mask_scan   one scan.cuh scan of the mask; its epilogue writes
//                   src[pos] = i for each kept entry i at output position
//                   pos = count(mask[:i + 1]) - 1 < out_pad, and the last
//                   thread the full count (int64, the reference's dtype
//                   under x64); src is zeroed first, so positions past the
//                   count hold 0 as in the reference. Positions are
//                   distinct, so no atomic.
//   pqt_take_rows   out[j] = rows[src[j]] for j < min(count, out_rows), and
//                   rows[0] past it (zeros when there are no rows), over
//                   rows of any byte width: one thread per output row
//                   copies the row in the widest word that divides its
//                   width and its alignment.
//
// One scan then serves every leaf of a row group (1-D values, a
// MaskedColumn's values and mask, a RaggedColumn's [rows, max_len] values
// and lengths): the reader syncs once for the count and gathers each leaf
// into exactly the kept rows.
//
// Bound on an H100: memory. Bytes: the mask read once (1 B per entry), the
// kept rows read and written once each, src written and read (4 B per kept
// row); the scan adds its 8 B per entry.

#include "scan.cuh"

namespace {

struct Kept {
  const uint8_t* mask;
  __device__ int32_t operator()(long long i) const { return mask[i] != 0 ? 1 : 0; }
};

struct Place {
  const uint8_t* mask;
  long long n, out_pad;
  int32_t* src;
  long long* count;
  __device__ void operator()(long long i, int32_t incl, int32_t total) const {
    const long long pos = (long long)incl - 1;
    if (mask[i] != 0 && pos < out_pad) src[pos] = (int32_t)i;
    if (i == n - 1) *count = (long long)total;
  }
};

template <typename W>
__global__ void take(const W* __restrict__ rows, long long n_src, long long wpr,
                     const int32_t* __restrict__ src, const long long* __restrict__ count,
                     long long out_rows, W* __restrict__ out) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= out_rows) return;
  W* dst = out + j * wpr;
  if (n_src == 0) {
    for (long long w = 0; w < wpr; ++w) dst[w] = W(0);
    return;
  }
  const long long c = *count < out_rows ? *count : out_rows;
  const W* s = rows + (j < c ? (long long)src[j] : 0) * wpr;
  for (long long w = 0; w < wpr; ++w) dst[w] = s[w];
}

template <typename W>
int launch_take(const void* rows, long long n_src, long long row_bytes, const void* src,
                const void* count, long long out_rows, void* out, cudaStream_t s) {
  take<W><<<(unsigned)((out_rows + 255) / 256), 256, 0, s>>>(
      (const W*)rows, n_src, row_bytes / (long long)sizeof(W), (const int32_t*)src,
      (const long long*)count, out_rows, (W*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// mask: bool[n]; src: int32[out_pad]; count: int64[1]; partial: int32[n]
// and tile_sums: the scan's scratch.
extern "C" int pqt_mask_scan(const void* mask, long long n, long long out_pad, void* src,
                             void* count, void* partial, void* tile_sums, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  // positions past the count hold 0, as the reference's zero-initialised src
  if (out_pad > 0) {
    int rc = (int)cudaMemsetAsync(src, 0, (size_t)out_pad * sizeof(int32_t), s);
    if (rc) return rc;
  }
  const uint8_t* m = (const uint8_t*)mask;
  return scan::run<int32_t>(Kept{m}, Place{m, n, out_pad, (int32_t*)src, (long long*)count},
                            n, (int32_t*)partial, (int32_t*)tile_sums, s);
}

// rows: n_src rows of row_bytes bytes; src: int32[>= min(count, out_rows)];
// count: int64[1] on the device; out: out_rows rows. `word` (8, 4, 2 or 1)
// divides row_bytes and the alignment of `rows`: the width each copy moves.
extern "C" int pqt_take_rows(const void* rows, long long n_src, long long row_bytes,
                             int word, const void* src, const void* count,
                             long long out_rows, void* out, void* stream) {
  if (out_rows <= 0 || row_bytes <= 0) return 0;
  if (word <= 0 || row_bytes % word) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (word) {
    case 8:
      return launch_take<unsigned long long>(rows, n_src, row_bytes, src, count,
                                             out_rows, out, s);
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
