// Mixed dict/PLAIN numeric merge: one output row per thread. A row of a
// dictionary page reads dict[idx_all[aux[pg] + rel]]; a row of a PLAIN page
// reads plain[aux[pg] + rel]; pg is the row's page and rel its offset in it.
//
// Replaces parquet_tpu/kernels/device_ops.py:merge_mixed_numeric_device (a
// searchsorted over the page row starts, two gathers and a select under
// XLA, over rows_pad padded rows). The JAX pipeline zero-pads idx_all, the
// dictionary and the PLAIN upload to power-of-two buckets (_pad_device)
// before the call, and the program clamps its indices against those padded
// shapes, so out-of-range indices read the padding's zeros. The kernel gives
// the same results from the padded sizes alone (d_pad, dict_pad, plain_pad)
// without materializing the padding:
//   src = max(aux[pg] + rel, 0)
//   dict row:  j = min(src, d_pad - 1); k = j < d ? idx_all[j] : 0;
//              k = clamp(k, 0, dict_pad - 1); out = k < n_dict ? dict[k] : 0
//   PLAIN row: j = min(src, plain_pad - 1); out = j < n_plain ? plain[j] : 0
//
// Bound on an H100: memory. Bytes: the dict rows' indices (4 B each), the
// dictionary, the PLAIN rows' values and the output, each once. The page
// search runs over a table of a few dozen entries that stays in L1.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void merge_numeric_kernel(
    const int32_t* __restrict__ idx_all, long long d, long long d_pad,
    const T* __restrict__ dict, long long n_dict, long long dict_pad,
    const T* __restrict__ plain, long long n_plain, long long plain_pad,
    const int32_t* __restrict__ page_kind, const int32_t* __restrict__ prs,
    const int32_t* __restrict__ aux, int p_pad, long long n_rows,
    T* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_rows; i += stride) {
    // pg = #{prs[1..p_pad] <= i}, clamped to the last page slot
    int lo = 0, hi = p_pad;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if ((long long)__ldg(prs + 1 + mid) <= i) lo = mid + 1; else hi = mid;
    }
    const int pg = lo < p_pad - 1 ? lo : p_pad - 1;
    long long src = (long long)__ldg(aux + pg) + (i - (long long)__ldg(prs + pg));
    if (src < 0) src = 0;
    T v = T(0);
    if (__ldg(page_kind + pg) == 1) {
      const long long j = src < d_pad - 1 ? src : d_pad - 1;
      long long k = j < d ? (long long)idx_all[j] : 0;
      k = k < 0 ? 0 : (k > dict_pad - 1 ? dict_pad - 1 : k);
      if (k < n_dict) v = dict[k];
    } else {
      const long long j = src < plain_pad - 1 ? src : plain_pad - 1;
      if (j < n_plain) v = plain[j];
    }
    out[i] = v;
  }
}

template <typename T>
int launch(const void* idx, long long d, long long d_pad, const void* dict,
           long long n_dict, long long dict_pad, const void* plain,
           long long n_plain, long long plain_pad, const void* kind,
           const void* prs, const void* aux, int p_pad, long long n_rows,
           void* out, void* stream) {
  if (n_rows <= 0) return 0;
  const int threads = 256;
  long long blocks = (n_rows + threads - 1) / threads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;
  merge_numeric_kernel<T><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)idx, d, d_pad, (const T*)dict, n_dict, dict_pad,
      (const T*)plain, n_plain, plain_pad, (const int32_t*)kind,
      (const int32_t*)prs, (const int32_t*)aux, p_pad, n_rows, (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pqt_merge_mixed_numeric4(
    const void* idx, long long d, long long d_pad, const void* dict,
    long long n_dict, long long dict_pad, const void* plain, long long n_plain,
    long long plain_pad, const void* kind, const void* prs, const void* aux,
    int p_pad, long long n_rows, void* out, void* stream) {
  return launch<uint32_t>(idx, d, d_pad, dict, n_dict, dict_pad, plain, n_plain,
                          plain_pad, kind, prs, aux, p_pad, n_rows, out, stream);
}

extern "C" int pqt_merge_mixed_numeric8(
    const void* idx, long long d, long long d_pad, const void* dict,
    long long n_dict, long long dict_pad, const void* plain, long long n_plain,
    long long plain_pad, const void* kind, const void* prs, const void* aux,
    int p_pad, long long n_rows, void* out, void* stream) {
  return launch<unsigned long long>(idx, d, d_pad, dict, n_dict, dict_pad, plain,
                                    n_plain, plain_pad, kind, prs, aux, p_pad,
                                    n_rows, out, stream);
}
