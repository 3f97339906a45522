// Ragged rows padded to a fixed width: a flat element vector and per-row
// lengths into a [rows, max_len] matrix.
//
// Replaces the jitted inner `pad` of parquet_tpu/core/reader.py:
// _pad_ragged_device (under XLA: a cumsum of the lengths, a [rows, max_len]
// index matrix, a clipped gather and a select). The lengths are int32 or
// int64 (the reference's host reduceat gives either); with offs the
// exclusive scan of the lengths cast to int32 (wrapping as the reference's
// int32 cumsum does):
//
//   out[r, j] = j < lengths[r] ? values[clip(offs[r] + j, 0, nv - 1)] : 0
//
// and all zeros when nv == 0. Elements are copied by byte width (1, 4 or 8
// bytes), so bool, integer and float columns share one kernel and a float
// zero is the bit pattern 0.
//
// Two steps: a scan.cuh scan of the lengths whose epilogue turns the
// inclusive scan into the exclusive offsets in place (the partial buffer is
// the offsets scratch), then one thread per output slot (grid-stride),
// neighbouring threads on neighbouring slots of a row, so the writes are
// coalesced and the reads of a row's elements are contiguous.
//
// Bound on an H100: memory. Bytes: lengths read once (4 or 8 B per row), the
// elements read once (E B each) and the padded matrix written once
// (rows x max_len x E). The scan adds 8 B per row; the gather reads each
// row's length and offset once per slot, from L1.

#include "scan.cuh"

namespace {

template <typename L>
struct Length {
  const L* lengths;
  __device__ int32_t operator()(long long r) const { return (int32_t)lengths[r]; }
};

template <typename L>
struct Exclusive {
  const L* lengths;
  int32_t* offs;
  __device__ void operator()(long long r, int32_t incl, int32_t) const {
    offs[r] = (int32_t)((uint32_t)incl - (uint32_t)(int32_t)lengths[r]);
  }
};

template <typename E, typename L>
__global__ void pad_gather(const E* __restrict__ values, long long nv,
                           const L* __restrict__ lengths,
                           const int32_t* __restrict__ offs, long long rows,
                           int max_len, E* __restrict__ out) {
  const long long total = rows * (long long)max_len;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += stride) {
    const long long r = t / max_len;
    const int j = (int)(t - r * max_len);
    E v = E(0);
    if (nv > 0 && (long long)j < (long long)lengths[r]) {
      long long idx = (int32_t)((uint32_t)offs[r] + (uint32_t)j);
      idx = idx < 0 ? 0 : (idx >= nv ? nv - 1 : idx);
      v = values[idx];
    }
    out[t] = v;
  }
}

template <typename E, typename L>
int launch(const void* values, long long nv, const void* lengths, long long rows,
           int max_len, void* out, void* offs, void* tile_sums, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const L* len = (const L*)lengths;
  int32_t* o = (int32_t*)offs;
  int rc = scan::run<int32_t>(Length<L>{len}, Exclusive<L>{len, o}, rows, o,
                              (int32_t*)tile_sums, s);
  if (rc) return rc;
  const long long total = rows * (long long)max_len;
  if (total <= 0) return 0;
  long long blocks = (total + 255) / 256;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;
  pad_gather<E, L><<<(unsigned)blocks, 256, 0, s>>>((const E*)values, nv, len, o,
                                                     rows, max_len, (E*)out);
  return (int)cudaGetLastError();
}

template <typename L>
int by_width(const void* values, long long nv, int elem_bytes, const void* lengths,
             long long rows, int max_len, void* out, void* offs, void* tile_sums,
             void* stream) {
  switch (elem_bytes) {
    case 1:
      return launch<uint8_t, L>(values, nv, lengths, rows, max_len, out, offs, tile_sums,
                                stream);
    case 4:
      return launch<uint32_t, L>(values, nv, lengths, rows, max_len, out, offs, tile_sums,
                                 stream);
    case 8:
      return launch<unsigned long long, L>(values, nv, lengths, rows, max_len, out, offs,
                                           tile_sums, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int pqt_pad_ragged(const void* values, long long nv, int elem_bytes,
                              const void* lengths, int len_bytes, long long rows,
                              int max_len, void* out, void* offs, void* tile_sums,
                              void* stream) {
  if (len_bytes == 4)
    return by_width<int32_t>(values, nv, elem_bytes, lengths, rows, max_len, out, offs,
                             tile_sums, stream);
  if (len_bytes == 8)
    return by_width<long long>(values, nv, elem_bytes, lengths, rows, max_len, out, offs,
                               tile_sums, stream);
  return (int)cudaErrorInvalidValue;
}
