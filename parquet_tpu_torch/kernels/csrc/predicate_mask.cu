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
// pqt_predicate_mask: one flat grid, one step a thread, 32-bit indices
// (n < 2^31). When the values are 16-byte aligned a thread takes
// max(16 / sizeof(T), 4) elements (16 int8, 8 int16, 4 of 4 or 8 bytes) in
// one or two 16-byte loads and stores their bools in one 4-, 8- or 16-byte
// write; values off the alignment go 4 a thread, element by element, with
// one 4-byte write; the last thread takes the ragged tail. The op is a
// template parameter and the host folds the bracket rule into it (an
// inexact == or != fills the mask with one value, an inexact < or >
// becomes <= or >=), so the element loop holds one compare; an in-list
// walks its members once for all of a thread's elements. Each value is
// compared in its own type where that is exact. Timed on an H100 against
// the first version of this kernel (a switch per element, every value
// widened to 64 bits, 4 a thread) and against 32-byte steps and 128-thread
// blocks, this shape was the fastest (PERF.md). Values are 1-, 2-, 4- or 8-byte; `dtype`
// picks how a stored element is read and the type it compares in:
//
//   0..2  int8/int16/int32, compared as int32 (bool columns arrive as
//         int8, as the reference compares them); the host has coerced the
//         bracket and the members into the column's range
//   3     int64, compared as int64
//   4, 5  int32/int64 bit patterns compared as uint32/uint64, after
//         `& umask` (the sub-width mask)
//   6, 7  float32/float64, compared in their own type: the host rounds a
//         float32 column's bracket and members to float32, and a float32
//         value and a float32-rounded bracket compare in float32 exactly as
//         they do in double, NaN included
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
// bytes of values a thread reads from 16-byte-aligned values (one 16-byte
// load), and the fewest elements it takes: max(kStepBytes / sizeof(T),
// kMinPer) values (device_ops.predicate_block). Values off the alignment go
// kMinPer a thread, element by element.
constexpr int kStepBytes = 16;
constexpr int kMinPer = 4;

template <typename T>
__host__ __device__ constexpr int per_step() {
  return kStepBytes / (int)sizeof(T) < kMinPer ? kMinPer : kStepBytes / (int)sizeof(T);
}

// an unsigned word of 4, 8 or 16 bytes, and the widest of them up to b bytes
template <int kBytes> struct Word;
template <> struct Word<4> { using type = uint32_t; };
template <> struct Word<8> { using type = uint2; };
template <> struct Word<16> { using type = uint4; };
__host__ __device__ constexpr int vec_bytes(int b) { return b < 16 ? b : 16; }

// kN elements of T, seen as themselves or as the words they load or store in
template <typename T, int kN>
struct Vec {
  static constexpr int kBytes = kN * (int)sizeof(T);
  using word = typename Word<vec_bytes(kBytes)>::type;
  static constexpr int kWords = kBytes / vec_bytes(kBytes);
  union type {
    word q[kWords];
    T x[kN];
  };
};

// the six comparisons after the bracket rule, and the in-list
enum Op { kEq, kNe, kLt, kLe, kGt, kGe, kIn };

template <typename C>
struct Bracket {
  C v;
  unsigned long long umask;
};

template <typename C>
struct Members {
  int n;
  int negate;
  unsigned long long umask;
  C m[kMaxMembers];
};

// a stored element in its compare type
__device__ __forceinline__ int conv(int8_t x, unsigned long long) { return x; }
__device__ __forceinline__ int conv(int16_t x, unsigned long long) { return x; }
__device__ __forceinline__ int conv(int32_t x, unsigned long long) { return x; }
__device__ __forceinline__ long long conv(long long x, unsigned long long) { return x; }
__device__ __forceinline__ uint32_t conv(uint32_t x, unsigned long long m) {
  return x & (uint32_t)m;
}
__device__ __forceinline__ unsigned long long conv(unsigned long long x,
                                                   unsigned long long m) {
  return x & m;
}
__device__ __forceinline__ float conv(float x, unsigned long long) { return x; }
__device__ __forceinline__ double conv(double x, unsigned long long) { return x; }

template <int kOp, typename C>
__device__ __forceinline__ bool test(const Bracket<C>& p, C x) {
  if constexpr (kOp == kEq) return x == p.v;
  else if constexpr (kOp == kNe) return x != p.v;
  else if constexpr (kOp == kLt) return x < p.v;
  else if constexpr (kOp == kLe) return x <= p.v;
  else if constexpr (kOp == kGt) return x > p.v;
  else return x >= p.v;
}

template <int kOp, typename C>
__device__ __forceinline__ bool test(const Members<C>& p, C x) {
  bool hit = false;
  for (int k = 0; k < p.n; ++k) hit |= (x == p.m[k]);
  return hit != (p.negate != 0);
}

// the verdicts of kN stored elements; an in-list walks its members once
// for all kN
template <int kOp, typename C, typename T, int kN>
__device__ __forceinline__ void test_all(const Bracket<C>& p, const T (&x)[kN],
                                         uint8_t (&out)[kN]) {
#pragma unroll
  for (int k = 0; k < kN; ++k) out[k] = test<kOp>(p, conv(x[k], p.umask));
}

template <int kOp, typename C, typename T, int kN>
__device__ __forceinline__ void test_all(const Members<C>& p, const T (&x)[kN],
                                         uint8_t (&out)[kN]) {
  C v[kN];
  bool hit[kN];
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    v[k] = conv(x[k], p.umask);
    hit[k] = false;
  }
  for (int j = 0; j < p.n; ++j) {
    const C m = p.m[j];
#pragma unroll
    for (int k = 0; k < kN; ++k) hit[k] |= v[k] == m;
  }
#pragma unroll
  for (int k = 0; k < kN; ++k) out[k] = hit[k] != (p.negate != 0);
}

template <typename T, int kOp, typename P>
__global__ void __launch_bounds__(kThreads)
    predicate(const T* __restrict__ values, unsigned n, P p, int vec,
              bool* __restrict__ out) {
  const unsigned c = blockIdx.x * kThreads + threadIdx.x;  // this thread's step
  if (vec) {
    // kPer values in 16-byte (or narrower) loads, their bools in one store
    constexpr int kPer = per_step<T>();
    using Load = Vec<T, kPer>;
    using Store = Vec<uint8_t, kPer>;
    const unsigned i0 = c * kPer;
    if (i0 + kPer <= n) {
      typename Load::type g;
      const auto* src = reinterpret_cast<const typename Load::word*>(values + i0);
#pragma unroll
      for (int q = 0; q < Load::kWords; ++q) g.q[q] = __ldg(src + q);
      typename Store::type b;
      test_all<kOp>(p, g.x, b.x);
      auto* dst = reinterpret_cast<typename Store::word*>(out + i0);
#pragma unroll
      for (int q = 0; q < Store::kWords; ++q) dst[q] = b.q[q];
      return;
    }
    for (unsigned i = i0; i < n; ++i) out[i] = test<kOp>(p, conv(values[i], p.umask));
    return;
  }
  // kMinPer values element by element, their bools in one 4-byte store
  const unsigned i0 = c * kMinPer;
  if (i0 + kMinPer <= n) {
    T x[kMinPer];
#pragma unroll
    for (int k = 0; k < kMinPer; ++k) x[k] = values[i0 + k];
    typename Vec<uint8_t, kMinPer>::type b;
    test_all<kOp>(p, x, b.x);
    *reinterpret_cast<typename Vec<uint8_t, kMinPer>::word*>(out + i0) = b.q[0];
    return;
  }
  for (unsigned i = i0; i < n; ++i) out[i] = test<kOp>(p, conv(values[i], p.umask));
}

// one value in every slot: the bracket rule's all-false / all-true masks
__global__ void __launch_bounds__(kThreads)
    fill(unsigned n, uint32_t word, bool* __restrict__ out) {
  const unsigned i0 = (blockIdx.x * kThreads + threadIdx.x) * 16u;
  if (i0 + 16 <= n) {
    *reinterpret_cast<uint4*>(out + i0) = make_uint4(word, word, word, word);
    return;
  }
  for (unsigned i = i0; i < n; ++i) out[i] = word != 0;
}

// blocks for n elements at `per` a thread
unsigned grid_for(long long n, int per) {
  return (unsigned)((n + (long long)kThreads * per - 1) / ((long long)kThreads * per));
}

template <typename T, int kOp, typename P>
int launch(const void* values, long long n, const P& p, void* out, cudaStream_t stream) {
  const int vec = (uintptr_t)values % 16 == 0;
  predicate<T, kOp, P><<<grid_for(n, vec ? per_step<T>() : kMinPer), kThreads, 0, stream>>>(
      (const T*)values, (unsigned)n, p, vec, (bool*)out);
  return (int)cudaGetLastError();
}

int launch_fill(long long n, bool value, void* out, cudaStream_t stream) {
  fill<<<grid_for(n, 16), kThreads, 0, stream>>>((unsigned)n, value ? 0x01010101u : 0u,
                                                 (bool*)out);
  return (int)cudaGetLastError();
}

// the launch of one stored type T compared in type C; lo/hi/members arrive
// as the host's 64-bit values, exact in C after the host's coercion
template <typename T, typename C, typename H>
int dispatch(const void* values, long long n, int op, H lo, H hi, int exact,
             unsigned long long umask, const H* members, int n_members, void* out,
             cudaStream_t s) {
  if (op >= 6) {
    Members<C> p;
    p.n = n_members;
    p.negate = op == 7;
    p.umask = umask;
    for (int k = 0; k < kMaxMembers; ++k) p.m[k] = k < n_members ? (C)members[k] : C(0);
    return launch<T, kIn>(values, n, p, out, s);
  }
  const Bracket<C> l{(C)lo, umask}, h{(C)hi, umask};
  switch (op) {
    case 0: return exact ? launch<T, kEq>(values, n, l, out, s) : launch_fill(n, false, out, s);
    case 1: return exact ? launch<T, kNe>(values, n, l, out, s) : launch_fill(n, true, out, s);
    case 2: return exact ? launch<T, kLt>(values, n, l, out, s) : launch<T, kLe>(values, n, l, out, s);
    case 3: return launch<T, kLe>(values, n, l, out, s);
    case 4: return exact ? launch<T, kGt>(values, n, h, out, s) : launch<T, kGe>(values, n, h, out, s);
    default: return launch<T, kGe>(values, n, h, out, s);
  }
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
// `out` must be 16-byte aligned.
extern "C" int pqt_predicate_mask(const void* values, long long n, int dtype, int op,
                                  long long lo_i, long long hi_i, double lo_f,
                                  double hi_f, int exact, unsigned long long umask,
                                  const void* members_i, const void* members_f,
                                  int n_members, void* out, void* stream) {
  if (n <= 0) return 0;
  if (n >= (1ll << 31) || n_members < 0 || n_members > kMaxMembers || op < 0 || op > 7 ||
      (uintptr_t)out % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const auto* mi = (const long long*)members_i;
  const auto* mu = (const unsigned long long*)members_i;
  const auto* mf = (const double*)members_f;
  const auto ulo = (unsigned long long)lo_i, uhi = (unsigned long long)hi_i;
  switch (dtype) {
    case 0: return dispatch<int8_t, int>(values, n, op, lo_i, hi_i, exact, umask, mi, n_members, out, s);
    case 1: return dispatch<int16_t, int>(values, n, op, lo_i, hi_i, exact, umask, mi, n_members, out, s);
    case 2: return dispatch<int32_t, int>(values, n, op, lo_i, hi_i, exact, umask, mi, n_members, out, s);
    case 3: return dispatch<long long, long long>(values, n, op, lo_i, hi_i, exact, umask, mi, n_members, out, s);
    case 4: return dispatch<uint32_t, uint32_t>(values, n, op, ulo, uhi, exact, umask, mu, n_members, out, s);
    case 5: return dispatch<unsigned long long, unsigned long long>(values, n, op, ulo, uhi, exact, umask, mu, n_members, out, s);
    case 6: return dispatch<float, float>(values, n, op, lo_f, hi_f, exact, umask, mf, n_members, out, s);
    case 7: return dispatch<double, double>(values, n, op, lo_f, hi_f, exact, umask, mf, n_members, out, s);
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
