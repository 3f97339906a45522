// First-occurrence dictionary of a column's bit patterns: each row's
// dictionary index, each entry's first row, and the number of entries.
//
// Replaces parquet_tpu/kernels/device_ops.py:dict_indices_device (under XLA:
// a stable argsort, group boundaries, a cumsum, a segment scatter-min of
// first rows, a second argsort by first row, and scatters). The dictionary
// order is the order of first occurrence, so a hash does without any sort:
//
//   1. insert: an open-addressing table of at least 2n slots (a power of
//      two) holds int32 ROW ids, -1 when free. Row i probes from its key's
//      hash: atomicCAS(-1 -> i) claims a free slot; a taken slot whose row
//      holds the same key gets atomicMin(i) when i is smaller; another key
//      probes on. Each row records its slot. A plain read of the slot
//      comes first, so the rows of a frequent key (8 keys over 2^20 rows in
//      taxi's vendor_id) do not all queue atomics on one address. Keys are never stored, so every 32- or 64-bit
//      pattern (-1, INT_MIN, NaN payloads) is a legal key, and a slot's key
//      never changes once claimed, so every row of a key finds its slot.
//      When all inserts are done, a slot holds its key's first row,
//      whatever order the atomics ran in.
//   2. one scan.cuh scan over first[i] = (table[slot[i]] == i): the
//      epilogue keeps the inclusive count per row (a first row's rank is
//      count - 1), writes firsts[rank] = i at each first row and the total,
//      n_uniques.
//   3. indices[i] = rank of the first row of i's slot; firsts past
//      n_uniques are set to n.
//
// The outputs equal the reference's sort-based ones bit for bit, n_uniques
// included (counted in full, with no cut-off).
//
// Bound on an H100: memory. Bytes: the keys read (4 or 8 B), indices and
// firsts written (8 B per row). The table (8 B per row with its 2x slack),
// the slots and the scan's partial add about 24 B per row of scratch
// traffic, and the probes' compare reads of earlier rows' keys hit L2.

#include "scan.cuh"

namespace {

__device__ __forceinline__ unsigned long long mix(unsigned long long x) {
  x ^= x >> 33;
  x *= 0xff51afd7ed558ccdULL;
  x ^= x >> 33;
  x *= 0xc4ceb9fe1a85ec53ULL;
  x ^= x >> 33;
  return x;
}

template <typename K>
__global__ void insert(const K* __restrict__ keys, long long n, int32_t* table,
                       unsigned long long tmask, int32_t* __restrict__ slot_of) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const K k = keys[i];
  unsigned long long s = mix((unsigned long long)k) & tmask;
  for (;;) {
    // read before any atomic: a slot's row only ever falls, and its key
    // never changes, so a stale read is a row of the same key no smaller
    // than the slot's; rows of a frequent key then skip the atomics that
    // would otherwise queue on one address
    int32_t prev = *(volatile int32_t*)(table + s);
    if (prev == -1) {
      prev = atomicCAS(table + s, -1, (int32_t)i);
      if (prev == -1) break;
    }
    if (keys[prev] == k) {
      if ((int32_t)i < prev) atomicMin(table + s, (int32_t)i);
      break;
    }
    s = (s + 1) & tmask;
  }
  slot_of[i] = (int32_t)s;
}

struct IsFirst {
  const int32_t* table;
  const int32_t* slot_of;
  __device__ int32_t operator()(long long i) const {
    return table[slot_of[i]] == (int32_t)i ? 1 : 0;
  }
};

struct Rank {
  const int32_t* table;
  const int32_t* slot_of;
  long long n;
  int32_t* count;  // the scan's partial buffer: inclusive count of first rows
  int32_t* firsts;
  int32_t* n_uniques;
  __device__ void operator()(long long i, int32_t incl, int32_t total) const {
    count[i] = incl;
    if (table[slot_of[i]] == (int32_t)i) firsts[incl - 1] = (int32_t)i;
    if (i == n - 1) *n_uniques = total;
  }
};

__global__ void finish(const int32_t* __restrict__ table, const int32_t* __restrict__ slot_of,
                       const int32_t* __restrict__ count, const int32_t* __restrict__ n_uniques,
                       long long n, int32_t* __restrict__ indices, int32_t* __restrict__ firsts) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  indices[i] = count[table[slot_of[i]]] - 1;
  if (i >= *n_uniques) firsts[i] = (int32_t)n;
}

template <typename K>
int launch_insert(const void* keys, long long n, int32_t* table, long long tmask,
                  int32_t* slot_of, cudaStream_t s) {
  insert<K><<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
      (const K*)keys, n, table, (unsigned long long)tmask, slot_of);
  return (int)cudaGetLastError();
}

}  // namespace

// keys: n elements of elem_size (4 or 8) bytes; table: int32[tmask + 1],
// tmask + 1 a power of two >= 2n; scratch: int32[2n] (slots, counts);
// tile_sums: the scan's scratch; indices, firsts: int32[n]; n_uniques:
// int32[1].
extern "C" int pqt_dict_indices(const void* keys, long long n, int elem_size, void* table,
                                long long tmask, void* scratch, void* tile_sums,
                                void* indices, void* firsts, void* n_uniques, void* stream) {
  if (n <= 0) return 0;
  if ((elem_size != 4 && elem_size != 8) || tmask + 1 < 2 * n) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int32_t* tab = (int32_t*)table;
  int32_t* slot_of = (int32_t*)scratch;
  int32_t* count = slot_of + n;
  int rc = (int)cudaMemsetAsync(tab, 0xFF, (size_t)(tmask + 1) * sizeof(int32_t), s);
  if (rc) return rc;
  rc = elem_size == 4 ? launch_insert<uint32_t>(keys, n, tab, tmask, slot_of, s)
                      : launch_insert<unsigned long long>(keys, n, tab, tmask, slot_of, s);
  if (rc) return rc;
  rc = scan::run<int32_t>(
      IsFirst{tab, slot_of},
      Rank{tab, slot_of, n, count, (int32_t*)firsts, (int32_t*)n_uniques}, n, count,
      (int32_t*)tile_sums, s);
  if (rc) return rc;
  finish<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(tab, slot_of, count,
                                                      (const int32_t*)n_uniques, n,
                                                      (int32_t*)indices, (int32_t*)firsts);
  return (int)cudaGetLastError();
}
