// Null expansion: the dense non-null values of a nullable column scattered
// into row positions, nulls zero-filled.
//
// Replaces the jitted inner `expand` of parquet_tpu/core/reader.py:
// _expand_nullable_device (under XLA: a cumsum of the validity mask, a
// clipped gather and a select):
//
//   out[i] = mask[i] ? values[clip(inclusive_count(mask)[i] - 1, 0, nv - 1)] : 0
//
// and all zeros when nv == 0. Elements are copied by byte width (1, 4 or 8
// bytes), so bool, integer and float columns share one kernel and a float
// zero is the bit pattern 0.
//
// One scan.cuh scan over the mask bytes; its epilogue is the gather, so the
// output is written in the scan's add pass, one thread per row, coalesced.
//
// Bound on an H100: memory. Bytes: the mask read once (1 B per row), the
// non-null values read once (E B each) and the output written once (E B
// per row). The scan adds 8 B per row (its int32 partial written and read).

#include "scan.cuh"

namespace {

struct Valid {
  const uint8_t* mask;
  __device__ int32_t operator()(long long i) const { return mask[i] != 0 ? 1 : 0; }
};

template <typename E>
struct Gather {
  const E* values;
  long long nv;
  const uint8_t* mask;
  E* out;
  __device__ void operator()(long long i, int32_t incl, int32_t) const {
    E v = E(0);
    if (nv > 0 && mask[i] != 0) {
      long long idx = (long long)incl - 1;
      idx = idx < 0 ? 0 : (idx >= nv ? nv - 1 : idx);
      v = values[idx];
    }
    out[i] = v;
  }
};

template <typename E>
int launch(const void* values, long long nv, const void* mask, long long n, void* out,
           void* partial, void* tile_sums, void* stream) {
  const uint8_t* m = (const uint8_t*)mask;
  return scan::run<int32_t>(Valid{m}, Gather<E>{(const E*)values, nv, m, (E*)out}, n,
                            (int32_t*)partial, (int32_t*)tile_sums,
                            (cudaStream_t)stream);
}

}  // namespace

extern "C" int pqt_expand_nullable(const void* values, long long nv, int elem_bytes,
                                   const void* mask, long long n, void* out,
                                   void* partial, void* tile_sums, void* stream) {
  switch (elem_bytes) {
    case 1:
      return launch<uint8_t>(values, nv, mask, n, out, partial, tile_sums, stream);
    case 4:
      return launch<uint32_t>(values, nv, mask, n, out, partial, tile_sums, stream);
    case 8:
      return launch<unsigned long long>(values, nv, mask, n, out, partial, tile_sums,
                                        stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
