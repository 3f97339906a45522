// A leaf's row mask from a verdict over its dense values.
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
// the kernel writes out[i] = V(i) for a column without nulls, and with a
// row validity
//
//   out[i] = valid[i] && nd > 0 ? V(clip(count(valid[:i + 1]) - 1, 0, nd - 1))
//                               : fill
//
// A thread takes 16 consecutive rows and writes them as one 16-byte store
// (byte by byte at the end of the rows or where `out` is off 16 bytes):
//
//   without a validity (gather): the thread loads its 16 indices as four
//      16-byte vectors (its 16 verdict bytes as one for a dense verdict;
//      one by one where the input is off 16 bytes) and gathers the
//      verdict. At a 100,000-entry verdict the random gathers are half the
//      time: each SM pulls nearly all of the verdict from L2, 32 B a miss;
//      packing it to bits first, staging it in shared memory and reading
//      it across a cluster all cost as much or more (PERF.md §6).
//   with a validity: two launches over tiles of kThreads x kItems rows, a
//      thread's rows read as 16-byte vectors of the validity:
//        1. counts (validity.cuh): each tile's count of valid rows;
//        1b. group_counts, past one group of kGroup tiles: each group's;
//        2. place: each block sums the earlier groups' counts and its
//           group's earlier tiles' (one round of kThreads each), scans its
//           threads' counts, and each thread gathers V at its valid rows'
//           dense indices and stores its rows.
//      No scratch of n rows and no look-back: at a row group (256 tiles)
//      the two launches beat a descriptor memset and one launch with a
//      decoupled look-back, and the group level keeps the sum linear past
//      it (PERF.md §6).
//
// Bound on an H100: memory. Bytes: the verdict (1 B per entry), the
// indices (4 B per dense value) and the validity (1 B per row) read once,
// the mask written once (1 B per row); launch 2 reads the validity again
// (from L2). At a row group (2^20 rows) the launches are most of the time.

#include "validity.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;  // rows a thread; kThreads * kItems: device_ops.LEAF_VERDICT_TILE
constexpr int kGroup = kThreads;  // tiles a group: device_ops.LEAF_VERDICT_GROUP
static_assert(kGroup == kThreads, "validity.cuh groups kThreads tiles");

// jnp's index rule: a negative index wraps once, then clamps into range.
__device__ __forceinline__ long long wrap_clamp(long long j, long long n_verdict) {
  if (j < 0) j += n_verdict;
  return j < 0 ? 0 : (j >= n_verdict ? n_verdict - 1 : j);
}

struct Verdict {
  const uint8_t* verdict;
  long long n_verdict;
  const int32_t* indices;  // nullptr: the verdict is dense already
  __device__ __forceinline__ uint32_t at(long long k) const {
    if (indices == nullptr) return verdict[k] != 0;
    return verdict[wrap_clamp(indices[k], n_verdict)] != 0;
  }
};

// Bytes first .. first + 15 of `out` (whole 16-byte stores where aligned),
// none at or past n.
__device__ __forceinline__ void store16(uint8_t* out, long long first, long long n, bool vec,
                                        const uint32_t (&w)[4]) {
  if (vec && first + 16 <= n) {
    *reinterpret_cast<uint4*>(out + first) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 16; ++e)
      if (first + e < n) out[first + e] = (uint8_t)(w[e >> 2] >> (8 * (e & 3)));
  }
}

// A thread's 16 indices from first on (0 at and past n).
__device__ __forceinline__ void load_indices(const int32_t* indices, long long first, long long n,
                                             bool whole, int32_t (&idx)[16]) {
  if (whole) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int4 x = *reinterpret_cast<const int4*>(indices + first + 4 * q);
      idx[4 * q] = x.x;
      idx[4 * q + 1] = x.y;
      idx[4 * q + 2] = x.z;
      idx[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 16; ++e) idx[e] = first + e < n ? indices[first + e] : 0;
  }
}

// Launch without a validity: out[i] = V(i), 16 consecutive rows a thread.
// `vec`: the indices (or the dense verdict) are 16-byte aligned; `ovec`:
// out is.
__global__ void __launch_bounds__(kThreads)
    gather(Verdict v, long long n, bool vec, bool ovec, uint8_t* __restrict__ out) {
  const long long first = ((long long)blockIdx.x * kThreads + threadIdx.x) * 16;
  if (first >= n) return;
  const bool whole = vec && first + 16 <= n;
  uint32_t w[4] = {0, 0, 0, 0};
  if (v.indices == nullptr) {
    if (whole) {
      const uint4 q = *reinterpret_cast<const uint4*>(v.verdict + first);
      w[0] = validity::nonzero_bytes(q.x);
      w[1] = validity::nonzero_bytes(q.y);
      w[2] = validity::nonzero_bytes(q.z);
      w[3] = validity::nonzero_bytes(q.w);
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e)
        if (first + e < n) w[e >> 2] |= v.at(first + e) << (8 * (e & 3));
    }
  } else {
    int32_t idx[16];
    load_indices(v.indices, first, n, whole, idx);
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const long long j = wrap_clamp(idx[e], v.n_verdict);
      if (first + e < n) w[e >> 2] |= (uint32_t)(v.verdict[j] != 0) << (8 * (e & 3));
    }
  }
  store16(out, first, n, ovec, w);
}

// Launch 2: the tile's rows. A valid row reads V at its dense index, a null
// row gets `fill`.
__global__ void __launch_bounds__(kThreads)
    place(Verdict v, const uint8_t* __restrict__ valid, long long n, bool vec, long long nd,
          uint32_t fill, const uint32_t* __restrict__ tile_counts,
          const uint32_t* __restrict__ groups, bool ovec, uint8_t* __restrict__ out) {
  __shared__ uint32_t s_part[kThreads / 32];
  __shared__ uint32_t s_warp[kThreads / 32];
  const long long tile = blockIdx.x;
  const uint32_t b = validity::share_before<kThreads, kGroup>(tile_counts, groups, tile);
  const long long first = (tile * kThreads + threadIdx.x) * kItems;
  uint32_t w[kItems / 4];
  validity::load_valid<kItems>(valid, first, n, vec, w);
  const uint32_t c = validity::count_bytes<kItems>(w);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t x = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  // the rows before the thread's: earlier tiles, earlier warps, earlier lanes
  uint32_t acc = validity::block_sum<kThreads>(b, s_part) + x - c;
#pragma unroll
  for (int k = 0; k < kThreads / 32; ++k)
    if (k < warp) acc += s_warp[k];
#pragma unroll
  for (int q = 0; q < kItems / 16; ++q) {
    const long long f = first + 16 * q;
    if (f >= n) return;
    uint32_t o[4] = {0, 0, 0, 0};
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const uint32_t bit = (w[4 * q + (e >> 2)] >> (8 * (e & 3))) & 1u;
      acc += bit;
      uint32_t r = fill;
      if (bit && nd > 0) {
        long long k = (long long)acc - 1;
        k = k < 0 ? 0 : (k >= nd ? nd - 1 : k);
        r = v.at(k);
      }
      o[e >> 2] |= r << (8 * (e & 3));
    }
    store16(out, f, n, ovec, o);
  }
}

}  // namespace

// verdict: uint8[n_verdict]; indices: int32[nd] or null (then n_verdict ==
// nd); valid: uint8[n] or null (then n == nd); out: bool[n]; scratch: with
// a validity, uint32[t + ceil(t / kGroup)] for t = ceil(n / (kThreads *
// kItems)) tiles (each tile's count of valid rows, then each group's),
// unused without one.
extern "C" int pqt_leaf_verdict(const void* verdict, long long n_verdict,
                                const void* indices, long long nd, const void* valid,
                                long long n, int fill, void* out, void* scratch,
                                void* stream) {
  if (n <= 0) return 0;
  const Verdict v{(const uint8_t*)verdict, n_verdict, (const int32_t*)indices};
  cudaStream_t s = (cudaStream_t)stream;
  const bool ovec = validity::aligned16(out);
  if (valid == nullptr) {
    const long long blocks = ((n + 15) / 16 + kThreads - 1) / kThreads;
    gather<<<(unsigned)blocks, kThreads, 0, s>>>(
        v, n, validity::aligned16(indices == nullptr ? verdict : indices), ovec, (uint8_t*)out);
    return (int)cudaGetLastError();
  }
  const long long ntiles = validity::num_tiles(n, kThreads * kItems);
  uint32_t* tile_counts = (uint32_t*)scratch;
  const uint8_t* m = (const uint8_t*)valid;
  const int rc = validity::count_tiles<kThreads, kItems>(m, n, ntiles, tile_counts, s);
  if (rc) return rc;
  place<<<(unsigned)ntiles, kThreads, 0, s>>>(v, m, n, validity::aligned16(valid), nd,
                                             fill != 0 ? 1u : 0u, tile_counts,
                                             tile_counts + ntiles, ovec, (uint8_t*)out);
  return (int)cudaGetLastError();
}
