// One leaf predicate over a column's dense values -> bool mask.
//
// Replaces parquet_tpu/kernels/device_ops.py:predicate_mask_device (under
// XLA: one elementwise compare against the bracket (lo, hi, exact)), and
// the inline jnp ops of parquet_tpu/core/filter_device.py that feed it: the
// unsigned bitcast and sub-width mask of _device_numeric_view (:378-394),
// the OR of equality masks of an in-list (_member_mask, :261-283, with `~`
// for not_in), over dense values and FIXED_LEN_BYTE_ARRAY rows alike, and
// _fixed_compare's all(arr == pattern, axis=1) over those rows (:397-411).
//
// pqt_predicate_mask: each thread takes kPer consecutive elements and
// stores their bools in one 4-byte write; the loads are one vector load
// when the values are aligned to kPer elements (else element by element).
// Values are 1-, 2-, 4- or 8-byte; `dtype` picks how a stored element is
// read:
//
//   0..3  int8/int16/int32/int64, compared as signed 64-bit integers
//         (bool columns arrive as int8, as the reference compares them)
//   4, 5  int32/int64 bit patterns compared as unsigned 64-bit integers,
//         after `& umask` (the sub-width mask)
//   6, 7  float32/float64, compared as double: a float32 value and a
//         float32-rounded bracket compare in double exactly as they do in
//         float32, NaN included
//
// `op`: 0 ==, 1 !=, 2 <, 3 <=, 4 >, 5 >=, with the reference's bracket
// rule (an inexact bracket makes == all false and != all true, and the
// ordered ops use the end that stays exact); 6 in, 7 not_in against up to
// kMaxMembers exact members. The host coerces the bracket to the column's
// dtype first (an out-of-range bracket never reaches the kernel). The six
// comparisons take a small bracket block by value; only an in-list carries
// its member table, also by value, so no upload precedes a launch.
//
// pqt_fixed_members: one thread per row of uint8[n, w]; a row hits when it
// equals one of n_patterns patterns of w bytes (a device table), and the
// verdict is negated for != and not_in. == and != pass one pattern; the
// host drops a pattern of another width, which can equal no row.
//
// Bound on an H100: memory. Bytes: each value read once, one bool written
// (E + 1 bytes per element; w + 1 per FLBA row).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxMembers = 64;  // device_ops.MAX_MEMBERS
constexpr int kThreads = 256;
constexpr int kPer = 4;

template <typename C>
struct Bracket {
  C lo, hi;
  int op;
  int exact;
  unsigned long long umask;
};

template <typename C>
struct Members {
  int n;
  int negate;
  unsigned long long umask;
  C m[kMaxMembers];
};

// a stored element in its compare domain
__device__ __forceinline__ long long conv(int8_t x, unsigned long long) { return x; }
__device__ __forceinline__ long long conv(int16_t x, unsigned long long) { return x; }
__device__ __forceinline__ long long conv(int32_t x, unsigned long long) { return x; }
__device__ __forceinline__ long long conv(long long x, unsigned long long) { return x; }
__device__ __forceinline__ unsigned long long conv(uint32_t x, unsigned long long m) {
  return (unsigned long long)x & m;
}
__device__ __forceinline__ unsigned long long conv(unsigned long long x,
                                                   unsigned long long m) {
  return x & m;
}
__device__ __forceinline__ double conv(float x, unsigned long long) { return x; }
__device__ __forceinline__ double conv(double x, unsigned long long) { return x; }

template <typename C>
__device__ __forceinline__ bool test(const Bracket<C>& p, C x) {
  switch (p.op) {
    case 0: return p.exact ? (x == p.lo) : false;
    case 1: return p.exact ? (x != p.lo) : true;
    case 2: return p.exact ? (x < p.lo) : (x <= p.lo);
    case 3: return x <= p.lo;
    case 4: return p.exact ? (x > p.hi) : (x >= p.hi);
    default: return x >= p.hi;
  }
}

template <typename C>
__device__ __forceinline__ bool test(const Members<C>& p, C x) {
  bool hit = false;
  for (int k = 0; k < p.n; ++k) hit |= (x == p.m[k]);
  return hit != (p.negate != 0);
}

template <typename T>
struct alignas(sizeof(T) * kPer) Group {
  T x[kPer];
};

template <typename T, typename P, bool kVec>
__global__ void __launch_bounds__(kThreads)
    predicate(const T* __restrict__ values, long long n, P p, bool* __restrict__ out) {
  const long long i0 = ((long long)blockIdx.x * kThreads + threadIdx.x) * kPer;
  if (i0 >= n) return;
  if (i0 + kPer > n) {  // the ragged tail
    for (long long i = i0; i < n; ++i) out[i] = test(p, conv(values[i], p.umask));
    return;
  }
  Group<T> g;
  if (kVec) {
    g = *reinterpret_cast<const Group<T>*>(values + i0);
  } else {
#pragma unroll
    for (int k = 0; k < kPer; ++k) g.x[k] = values[i0 + k];
  }
  uchar4 r;
  r.x = test(p, conv(g.x[0], p.umask));
  r.y = test(p, conv(g.x[1], p.umask));
  r.z = test(p, conv(g.x[2], p.umask));
  r.w = test(p, conv(g.x[3], p.umask));
  *reinterpret_cast<uchar4*>(out + i0) = r;  // out is 4-byte aligned, i0 % 4 == 0
}

template <typename T, typename P>
int launch(const void* values, long long n, const P& p, void* out, cudaStream_t stream) {
  const long long per_block = (long long)kThreads * kPer;
  const unsigned blocks = (unsigned)((n + per_block - 1) / per_block);
  if ((uintptr_t)values % sizeof(Group<T>) == 0)
    predicate<T, P, true><<<blocks, kThreads, 0, stream>>>((const T*)values, n, p, (bool*)out);
  else
    predicate<T, P, false><<<blocks, kThreads, 0, stream>>>((const T*)values, n, p, (bool*)out);
  return (int)cudaGetLastError();
}

// the launch of one stored type T compared in domain C
template <typename T, typename C>
int dispatch(const void* values, long long n, int op, C lo, C hi, int exact,
             unsigned long long umask, const C* members, int n_members, void* out,
             cudaStream_t s) {
  if (op <= 5) {
    const Bracket<C> p{lo, hi, op, exact, umask};
    return launch<T>(values, n, p, out, s);
  }
  Members<C> p;
  p.n = n_members;
  p.negate = op == 7;
  p.umask = umask;
  for (int k = 0; k < kMaxMembers; ++k) p.m[k] = k < n_members ? members[k] : C(0);
  return launch<T>(values, n, p, out, s);
}

__global__ void __launch_bounds__(kThreads)
    fixed_members(const uint8_t* __restrict__ rows, long long n, int w,
                  const uint8_t* __restrict__ patterns, int n_patterns, int negate,
                  bool* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint8_t* row = rows + i * (long long)w;
  bool hit = false;
  for (int m = 0; m < n_patterns && !hit; ++m) {
    const uint8_t* pat = patterns + (long long)m * w;
    bool eq = true;
    for (int k = 0; k < w && eq; ++k) eq = row[k] == pat[k];
    hit = eq;
  }
  out[i] = hit != (negate != 0);
}

}  // namespace

// `lo_i`/`hi_i`/`members_i` carry integer brackets (unsigned ones as their
// 64-bit patterns), `lo_f`/`hi_f`/`members_f` float ones; the members are
// host arrays of n_members (<= kMaxMembers) entries, read before the launch.
extern "C" int pqt_predicate_mask(const void* values, long long n, int dtype, int op,
                                  long long lo_i, long long hi_i, double lo_f,
                                  double hi_f, int exact, unsigned long long umask,
                                  const void* members_i, const void* members_f,
                                  int n_members, void* out, void* stream) {
  if (n <= 0) return 0;
  if (n_members < 0 || n_members > kMaxMembers || op < 0 || op > 7 ||
      (uintptr_t)out % 4 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const auto* mi = (const long long*)members_i;
  const auto* mu = (const unsigned long long*)members_i;
  const auto* mf = (const double*)members_f;
  const auto ulo = (unsigned long long)lo_i, uhi = (unsigned long long)hi_i;
  switch (dtype) {
    case 0: return dispatch<int8_t>(values, n, op, lo_i, hi_i, exact, umask, mi, n_members, out, s);
    case 1: return dispatch<int16_t>(values, n, op, lo_i, hi_i, exact, umask, mi, n_members, out, s);
    case 2: return dispatch<int32_t>(values, n, op, lo_i, hi_i, exact, umask, mi, n_members, out, s);
    case 3: return dispatch<long long>(values, n, op, lo_i, hi_i, exact, umask, mi, n_members, out, s);
    case 4: return dispatch<uint32_t>(values, n, op, ulo, uhi, exact, umask, mu, n_members, out, s);
    case 5: return dispatch<unsigned long long>(values, n, op, ulo, uhi, exact, umask, mu, n_members, out, s);
    case 6: return dispatch<float>(values, n, op, lo_f, hi_f, exact, umask, mf, n_members, out, s);
    case 7: return dispatch<double>(values, n, op, lo_f, hi_f, exact, umask, mf, n_members, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// `patterns`: a device table of n_patterns rows of w bytes (unread when
// n_patterns is 0).
extern "C" int pqt_fixed_members(const void* rows, long long n, int w, const void* patterns,
                                 int n_patterns, int negate, void* out, void* stream) {
  if (n <= 0) return 0;
  if (w < 0 || n_patterns < 0) return (int)cudaErrorInvalidValue;
  fixed_members<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                  (cudaStream_t)stream>>>((const uint8_t*)rows, n, w,
                                          (const uint8_t*)patterns, n_patterns, negate,
                                          (bool*)out);
  return (int)cudaGetLastError();
}
