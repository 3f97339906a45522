// One nesting depth's list layout (offsets, first def level per slot, slot
// count) from device-resident repetition and definition levels.
//
// Replaces parquet_tpu/kernels/device_ops.py:list_layout_device (under XLA:
// two cumsums, two scatter-adds and a sum). With
//
//   boundary[i]   = rep[i] <= parent_rep                 (entry opens a slot)
//   elem_start[i] = rep[i] <= parent_rep + 1 && dfl[i] >= elem_def
//   slot_of[i]    = (inclusive count of boundaries) - 1
//
// the reference scatters elem_start and where(boundary, dfl, 0) into slot
// clip(slot_of, 0, n - 1) and prefix-sums the counts. slot_of is
// non-decreasing, and each slot k < n_slots holds exactly one boundary
// entry b_k, so the scatters have closed forms and need no atomics:
//
//   offsets[0]   = 0
//   offsets[k]   = (count of elem_start at indices < b_k)   0 < k < n_slots
//   offsets[k]   = (count of all elem_start)                k >= max(n_slots, 1)
//   first_def[k] = dfl[b_k]  for k < n_slots, else 0
//
// Leading entries before the first boundary (slot_of == -1) fall into slot
// 0 through the clip, which the closed form keeps: offsets[1] counts them.
//
// Two launches after a memset of the look-back descriptors, with no scratch
// of n elements:
//
//   1. scan.cuh's one-pass vector scan (run1) over int64 items that pack the
//      two counts, the boundary flag in the high 32 bits and the element flag
//      in the low 32 (both counts stay below 2^31, so the low half never
//      carries), in tiles of kThreads x kItems entries. The loader reads one
//      16-byte vector of rep and one of dfl a 4-entry vector (entry by entry
//      where either is not 16-byte aligned). The epilogue gets each vector's
//      inclusive sums and items; for each boundary entry i of slot k it
//      stages offsets[k] and first_def[k] (dfl[i] read again, from L2) in
//      shared memory, and each warp stores its row's slots, which are
//      consecutive, as consecutive words.
//   2. tail: one thread a 4-entry chunk reads the grand total from the last
//      tile's descriptor and writes n_slots, offsets[n_slots .. n] (the
//      element total; 0 at index 0) and first_def[n_slots .. n - 1] (0) as
//      16-byte stores. At `sessions` (8 M entries, 1 M slots) the tail is most
//      of both outputs, so it streams; chunks below n_slots return at once.
//
// Every output entry has exactly one writer, so the result is
// deterministic.
//
// Bound on an H100: memory. Bytes: rep and dfl read once, offsets and
// first_def written once (16 B per entry); beyond that 16 B of descriptor a
// tile and dfl again at the boundary entries. The three-pass scan it
// replaced wrote and read an 8-byte partial per entry, read rep and dfl
// twice and walked every tile sum in one block (PERF.md §6).

#include "scan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 16;  // kThreads * kItems: device_ops.LIST_LAYOUT_TILE

struct Flags {
  const int32_t* rep;
  const int32_t* dfl;
  long long n, parent_rep, elem_def;
  bool vec;  // rep and dfl are 16-byte aligned
  __device__ long long item(int32_t r, int32_t d) const {
    return ((long long)((long long)r <= parent_rep) << 32) |
           (long long)((long long)r <= parent_rep + 1 && (long long)d >= elem_def);
  }
  __device__ void operator()(long long first, long long (&it)[4]) const {
    if (vec && first + 4 <= n) {
      const int4 r = *reinterpret_cast<const int4*>(rep + first);
      const int4 d = *reinterpret_cast<const int4*>(dfl + first);
      it[0] = item(r.x, d.x);
      it[1] = item(r.y, d.y);
      it[2] = item(r.z, d.z);
      it[3] = item(r.w, d.w);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        it[k] = first + k < n ? item(rep[first + k], dfl[first + k]) : 0;
    }
  }
};

// The boundary entries' slots. The 32 vectors of a warp's row (128
// consecutive entries) hold consecutive slots k0 .. k0 + count - 1: each
// boundary's (offset, def level) goes to shared memory at k - k0, and the
// warp stores the row's slots as consecutive words. Items past n are 0 (no
// boundary).
struct Slots {
  const int32_t* dfl;
  int32_t* offsets;
  int32_t* first_def;
  __device__ void operator()(long long first, const long long (&incl)[4],
                             const long long (&it)[4]) const {
    __shared__ int2 s_row[kThreads / 32][128];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const long long k0 = __shfl_sync(0xFFFFFFFFu, (incl[0] >> 32) - (it[0] >> 32), 0);
    const int count = (int)(__shfl_sync(0xFFFFFFFFu, incl[3] >> 32, 31) - k0);
    if (count == 0) return;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (!(it[e] >> 32)) continue;
      const long long k = (incl[e] >> 32) - 1;
      const int32_t e_before = (int32_t)((incl[e] & 0xffffffffll) - (it[e] & 1));
      s_row[warp][k - k0] = make_int2(k == 0 ? 0 : e_before, dfl[first + e]);
    }
    __syncwarp();
    for (int m = lane; m < count; m += 32) {
      const int2 x = s_row[warp][m];
      offsets[k0 + m] = x.x;
      first_def[k0 + m] = x.y;
    }
    __syncwarp();
  }
};

__global__ void __launch_bounds__(kThreads)
    tail(const unsigned long long* __restrict__ descriptors, long long ntiles, long long n,
         int32_t* __restrict__ offsets, int32_t* __restrict__ first_def,
         long long* __restrict__ n_slots_out, bool vec) {
  const unsigned long long total = scan::run1_total(descriptors, ntiles);
  const long long ns = (long long)(total >> 32);
  const int32_t e_total = (int32_t)(total & 0xffffffffull);
  const long long c = ((long long)blockIdx.x * kThreads + threadIdx.x) * 4;
  if (c == 0) *n_slots_out = ns;
  if (c + 4 <= ns || c > n) return;
  if (vec && c >= ns && c + 4 <= n) {
    *reinterpret_cast<int4*>(offsets + c) = make_int4(c == 0 ? 0 : e_total, e_total, e_total,
                                                      e_total);
    *reinterpret_cast<int4*>(first_def + c) = make_int4(0, 0, 0, 0);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long i = c + k;
      if (i < ns || i > n) continue;
      offsets[i] = i == 0 ? 0 : e_total;
      if (i < n) first_def[i] = 0;
    }
  }
}

inline bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

}  // namespace

// n >= 1 entries; offsets: int32[n + 1]; first_def: int32[n]; n_slots: one
// int64; descriptors: 2 + 2 * ceil(n / (kThreads * kItems)) 64-bit words.
extern "C" int pqt_list_layout(const void* rep, const void* dfl, long long n,
                               long long parent_rep, long long elem_def, void* offsets,
                               void* first_def, void* n_slots, void* descriptors,
                               void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const Flags f{(const int32_t*)rep, (const int32_t*)dfl, n, parent_rep, elem_def,
                aligned16(rep) && aligned16(dfl)};
  int rc = scan::run1<long long, kThreads, kItems, 4>(
      f, Slots{f.dfl, (int32_t*)offsets, (int32_t*)first_def}, n,
      (unsigned long long*)descriptors, s);
  if (rc) return rc;
  const long long chunks = (n + 1 + 3) / 4;
  tail<<<(unsigned)((chunks + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      (const unsigned long long*)descriptors, scan::run1_tiles<kThreads, kItems>(n), n,
      (int32_t*)offsets, (int32_t*)first_def, (long long*)n_slots,
      aligned16(offsets) && aligned16(first_def));
  return (int)cudaGetLastError();
}
