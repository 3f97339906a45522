// A leaf's row mask from a verdict over its dense values, in one pass.
//
// Replaces the inline jnp ops of parquet_tpu/core/filter_device.py that
// turn a verdict into a row mask: the verdict gather of a dictionary chunk
// `jnp.asarray(dcmp)[dc.indices]` (:252, :271: a host-computed bool
// verdict per dictionary entry, gathered through the resident int32
// indices with jnp's index rule: a negative index wraps once, then the
// index clamps into [0, n_dict - 1]); the validity scan of _valid_expand
// (:153-166: didx = clip(cumsum(valid) - 1, 0, nd - 1)); and the expansion
// `v & cmp[didx]` (row nulls false) or `(~v) | (v & cmp[didx])` (arrow's
// not_in keeps nulls) at :169-182. With
//
//   V(k) = indices ? verdict[clamp(wrap(indices[k]))] : verdict[k]
//
// the kernel writes out[i] = V(i) for a column without nulls (one thread
// per row), and with a row validity
//
//   out[i] = valid[i] && nd > 0 ? V(clip(count(valid[:i + 1]) - 1, 0, nd - 1))
//                               : fill
//
// as one scan.cuh scan over the validity bytes whose epilogue is the
// gather, as expand_nullable.cu does.
//
// Bound on an H100: memory. Bytes: the verdict (1 B per entry), the
// indices (4 B per dense value) and the validity (1 B per row) read once,
// the mask written once (1 B per row); the scan adds its 8 B per row.

#include "scan.cuh"

namespace {

struct Verdict {
  const uint8_t* verdict;
  long long n_verdict;
  const int32_t* indices;  // nullptr: the verdict is dense already
  __device__ bool operator()(long long k) const {
    if (indices == nullptr) return verdict[k] != 0;
    long long j = indices[k];
    if (j < 0) j += n_verdict;
    j = j < 0 ? 0 : (j >= n_verdict ? n_verdict - 1 : j);
    return verdict[j] != 0;
  }
};

__global__ void dense(Verdict v, long long n, bool* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = v(i);
}

struct Valid {
  const uint8_t* valid;
  __device__ int32_t operator()(long long i) const { return valid[i] != 0 ? 1 : 0; }
};

struct Expand {
  Verdict v;
  long long nd;
  const uint8_t* valid;
  bool fill;
  bool* out;
  __device__ void operator()(long long i, int32_t incl, int32_t) const {
    bool r = fill;
    if (valid[i] != 0 && nd > 0) {
      long long k = (long long)incl - 1;
      k = k < 0 ? 0 : (k >= nd ? nd - 1 : k);
      r = v(k);
    }
    out[i] = r;
  }
};

}  // namespace

// verdict: uint8[n_verdict]; indices: int32[nd] or null (then n_verdict ==
// nd); valid: uint8[n] or null (then n == nd); out: bool[n]. `partial`
// (int32[n]) and `tile_sums` are the scan's scratch, unused without a
// validity.
extern "C" int pqt_leaf_verdict(const void* verdict, long long n_verdict,
                                const void* indices, long long nd, const void* valid,
                                long long n, int fill, void* out, void* partial,
                                void* tile_sums, void* stream) {
  if (n <= 0) return 0;
  const Verdict v{(const uint8_t*)verdict, n_verdict, (const int32_t*)indices};
  cudaStream_t s = (cudaStream_t)stream;
  if (valid == nullptr) {
    dense<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(v, n, (bool*)out);
    return (int)cudaGetLastError();
  }
  const uint8_t* m = (const uint8_t*)valid;
  return scan::run<int32_t>(Valid{m}, Expand{v, nd, m, fill != 0, (bool*)out}, n,
                            (int32_t*)partial, (int32_t*)tile_sums, s);
}
