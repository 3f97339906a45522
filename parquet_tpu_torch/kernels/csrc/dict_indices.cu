// First-occurrence dictionary of a column's bit patterns: each row's
// dictionary index, each entry's first row, and the number of entries.
//
// Replaces parquet_tpu/kernels/device_ops.py:dict_indices_device (under XLA:
// a stable argsort, group boundaries, a cumsum, a segment scatter-min of
// first rows, a second argsort by first row, and scatters). The dictionary
// order is the order of first occurrence, so a hash does without any sort.
// Two kernels over tiles of kTile consecutive rows, after one memset:
//
//   1. insert: an open-addressing table of at least 2n slots (a power of
//      two) holds an entry a key: its first row + 1, 0 when free, with
//      kRepeated set when the key has more than one row. Keys are never
//      stored, so every 32- or 64-bit pattern (-1, INT_MIN, NaN payloads)
//      is a legal key, and a slot's key never changes once claimed. A block
//      first dedupes its tile in a shared-memory table of the same kind over
//      the tile's rows (keys staged in shared memory for the compare), one
//      round of rows a thread at a time, so a later round finds the earlier
//      rounds' keys claimed with smaller rows and needs no atomic; its
//      atomicMin leaves each key's first row in the tile. Only those
//      representatives probe the global table, a thread's probes advancing
//      together: atomicCAS(0 -> entry) claims a free slot; a slot of the same
//      key gets kRepeated (atomicOr) and atomicMin when the row is smaller (a
//      plain read first skips the atomics that would change nothing); another
//      key probes on. Every row records its representative's slot. When the
//      kernel ends, an entry holds its key's first row, whatever order the
//      atomics ran in.
//   2. rank, one pass: a row is its key's first when its entry's row is its
//      own. The tile counts its first rows with scan.cuh's single-pass
//      look-back (seg_tile_scan, no reset), writes firsts[rank] = row and,
//      for a repeated key, replaces the entry by -(rank + 1); it fills its
//      share of firsts[n_uniques, n) with n (the tile's non-first rows,
//      counted from the end) and the last tile writes n_uniques. A first
//      row's index is its rank; any other row reads its key's rank from the
//      entry, waiting (ld.relaxed.gpu) for the tile that writes it, which is
//      this one or an earlier one. Tiles are taken in start order
//      (next_tile), and a tile waits only for earlier ones, so the wait ends.
//
// The outputs equal the reference's sort-based ones bit for bit, n_uniques
// included (counted in full, with no cut-off).
//
// Bound on an H100: memory. Bytes: the keys read (4 or 8 B), indices and
// firsts written (8 B per row). Beyond them: the table's memset (8 B per
// row with its 2x slack), the row slots written and read (8 B per row), the
// table's random reads and atomics (L2) and 16 bytes of tile descriptor a
// tile. The random table traffic sets the time: on an H100 80GB HBM3 at
// 700 W (PERF.md §6, PR 9) 0.041 ms for taxi's trip_distance (2^20 rows,
// 1,066 keys), 0.024 for its 8-key vendor_id and 0.095 for its all-unique
// trip_id. The tile dedupe is for repeated keys: with every row probing the
// global table, 8 keys queued 0.051 ms of atomics on 8 addresses.

#include "scan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;  // device_ops.DICT_INDICES_TILE
constexpr int kBlockSlots = 2 * kTile;    // the tile's shared-memory table
// a table entry: row + 1 in the low 30 bits (rows < 2^30 - 1), kRepeated
// when the key has another row; negative once ranked: -(rank + 1)
constexpr int32_t kRepeated = 1 << 30;
constexpr int32_t kRowBits = kRepeated - 1;

__device__ __forceinline__ unsigned long long mix(unsigned long long x) {
  x ^= x >> 33;
  x *= 0xff51afd7ed558ccdULL;
  x ^= x >> 33;
  x *= 0xc4ceb9fe1a85ec53ULL;
  x ^= x >> 33;
  return x;
}

__device__ __forceinline__ int32_t ld_relaxed(const int32_t* p) {
  int32_t v;
  asm volatile("ld.relaxed.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(int32_t* p, int32_t v) {
  asm volatile("st.relaxed.gpu.global.s32 [%0], %1;" :: "l"(p), "r"(v) : "memory");
}

template <typename K>
__global__ void __launch_bounds__(kThreads)
    insert(const K* __restrict__ keys, long long n, int32_t* table, unsigned long long tmask,
           int32_t* __restrict__ slot_of) {
  __shared__ K s_key[kTile];
  __shared__ int32_t s_tab[kBlockSlots];  // tile row + 1, 0 free
  __shared__ int32_t s_gslot[kTile];      // a representative's global slot
  __shared__ bool s_rep_dup[kTile];       // the representative's key has another row here

  const long long base = (long long)blockIdx.x * kTile;
  for (int s = threadIdx.x; s < kBlockSlots; s += kThreads) s_tab[s] = 0;
  // item k of thread t is tile row k * kThreads + t
  int loc[kItems];
  K key[kItems];
  bool valid[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    loc[k] = k * kThreads + threadIdx.x;
    valid[k] = base + loc[k] < n;
    key[k] = valid[k] ? __ldg(keys + base + loc[k]) : K(0);
    s_key[loc[k]] = key[k];
    s_rep_dup[loc[k]] = false;
  }
  __syncthreads();
  int bslot[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    // one round of rows at a time: a later round's rows find the earlier
    // rounds' keys claimed with smaller rows and need no atomic
    int h = -1;
    if (valid[k]) {
      h = (int)(mix((unsigned long long)key[k]) >> 40) & (kBlockSlots - 1);
      for (;;) {
        int32_t prev = *(volatile int32_t*)(s_tab + h);
        if (prev == 0) {
          prev = atomicCAS(s_tab + h, 0, loc[k] + 1);
          if (prev == 0) break;
        }
        if (s_key[prev - 1] == key[k]) {
          if (loc[k] + 1 < prev) atomicMin(s_tab + h, loc[k] + 1);
          break;
        }
        h = (h + 1) & (kBlockSlots - 1);
      }
    }
    bslot[k] = h;
    __syncthreads();
  }
  int rep[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    rep[k] = valid[k] ? s_tab[bslot[k]] - 1 : -1;
    if (valid[k] && rep[k] != loc[k]) s_rep_dup[rep[k]] = true;
  }
  __syncthreads();
  // the tile's first rows of their keys probe the global table; a thread's
  // probes advance together, so their loads and atomics are in flight at
  // once. A slot's row only ever falls, kRepeated once set stays, and the
  // slot's key never changes, so a stale read is 0 (the CAS then returns the
  // entry) or an entry of the same key, no more recent.
  unsigned long long gs[kItems];
  int32_t mine[kItems];
  bool live[kItems];
  bool any = false;
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    live[k] = valid[k] && rep[k] == loc[k];
    gs[k] = mix((unsigned long long)key[k]) & tmask;
    mine[k] = (int32_t)(base + loc[k] + 1) | (live[k] && s_rep_dup[loc[k]] ? kRepeated : 0);
    any |= live[k];
  }
  while (any) {
    int32_t prev[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) prev[k] = live[k] ? table[gs[k]] : 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      if (live[k] && prev[k] == 0) prev[k] = atomicCAS(table + gs[k], 0, mine[k]);
    K other[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      other[k] = live[k] && prev[k] != 0 ? __ldg(keys + (prev[k] & kRowBits) - 1) : key[k];
    any = false;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (!live[k] || prev[k] == 0) {
        live[k] = false;  // done, or claimed
        continue;
      }
      if (other[k] == key[k]) {
        // another tile's row of this key: the key repeats; keep the least
        // row (every entry written after the mark carries it)
        if (!(prev[k] & kRepeated)) atomicOr(table + gs[k], kRepeated);
        if ((mine[k] & kRowBits) < (prev[k] & kRowBits))
          atomicMin(table + gs[k], mine[k] | kRepeated);
        live[k] = false;
        continue;
      }
      gs[k] = (gs[k] + 1) & tmask;
      any = true;
    }
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k)
    if (valid[k] && rep[k] == loc[k]) s_gslot[loc[k]] = (int32_t)gs[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kItems; ++k)
    if (valid[k]) slot_of[base + loc[k]] = s_gslot[rep[k]];
}

__global__ void __launch_bounds__(kThreads)
    rank_tiles(const int32_t* __restrict__ slot_of, long long n, int32_t* table,
               scan::SegTiles d, int32_t* __restrict__ indices, int32_t* __restrict__ firsts,
               int32_t* __restrict__ n_uniques) {
  __shared__ typename scan::SegBlockScan<uint32_t, kThreads>::TempStorage scan_temp;
  __shared__ unsigned int tile_slot;
  __shared__ uint32_t s_prefix, s_end;

  const long long tile = scan::next_tile(d, &tile_slot);
  const long long base = tile * kTile;
  const int rows = (int)min((long long)kTile, n - base);
  // blocked rows: item k of thread t is tile row t * kItems + k
  const int r0 = threadIdx.x * kItems;
  int32_t slot[kItems];
  if (r0 + kItems <= rows) {
    const int4 v = *reinterpret_cast<const int4*>(slot_of + base + r0);
    slot[0] = v.x;
    slot[1] = v.y;
    slot[2] = v.z;
    slot[3] = v.w;
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k) slot[k] = r0 + k < rows ? slot_of[base + r0 + k] : 0;
  }
  scan::SegPair<uint32_t> items[kItems];
  int32_t seen[kItems];
  bool first[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    // another tile may already have replaced the entry by its rank
    // (negative): either way the row is not this one's
    seen[k] = r0 + k < rows ? table[slot[k]] : -1;
    first[k] = seen[k] > 0 && (seen[k] & kRowBits) == (int32_t)(base + r0 + k) + 1;
    items[k].v = first[k] ? 1u : 0u;
    items[k].f = 0;
  }
  scan::seg_tile_scan<uint32_t, kThreads, kItems>(scan_temp, items, d, tile, false);
  int32_t out[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    // a first row's index is its rank; a repeated key's rank goes into its
    // entry for the key's other rows (a key of one row needs no entry)
    out[k] = seen[k];
    if (!first[k]) continue;
    out[k] = -(int32_t)items[k].v;
    firsts[-out[k] - 1] = (int32_t)(base + r0 + k);
    if (seen[k] & kRepeated) st_relaxed(table + slot[k], out[k]);
  }
  if (threadIdx.x == 0) s_prefix = items[0].v - (first[0] ? 1u : 0u);
  if (threadIdx.x == kThreads - 1) s_end = items[kItems - 1].v;
  __syncthreads();
  // firsts[n_uniques, n) hold n: the tile's share, its non-first rows,
  // counted back from the end
  const long long before = base - (long long)s_prefix;  // non-first rows before the tile
  const long long upto = base + rows - (long long)s_end;
  for (long long p = n - upto + threadIdx.x; p < n - before; p += kThreads)
    firsts[p] = (int32_t)n;
  if (base + rows == n && threadIdx.x == 0) *n_uniques = (int32_t)s_end;
  // the other rows take their key's rank: read at the flag already, or from
  // an earlier tile (or this one) that has written it or is about to
#pragma unroll
  for (int k = 0; k < kItems; ++k)
    if (out[k] > 0) out[k] = ld_relaxed(table + slot[k]);
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    while (out[k] > 0) out[k] = ld_relaxed(table + slot[k]);
    out[k] = -out[k] - 1;
  }
  if (r0 + kItems <= rows) {
    *reinterpret_cast<int4*>(indices + base + r0) = make_int4(out[0], out[1], out[2], out[3]);
  } else {
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      if (r0 + k < rows) indices[base + r0 + k] = out[k];
  }
}

static_assert(kItems == 4, "rank_tiles loads and stores a thread's rows as one int4");

// The table: a power of two of at least 2n slots (at least 64).
inline long long table_slots(long long n) {
  long long slots = 64;
  while (slots < 2 * n) slots <<= 1;
  return slots;
}

inline long long num_tiles(long long n) { return (n + kTile - 1) / kTile; }

}  // namespace

// 64-bit words of scratch a probe of n rows needs: the tile descriptors, the
// table and the rows' slots.
extern "C" int pqt_dict_indices_scratch_words(long long n) {
  return (int)(scan::seg_scratch_words(num_tiles(n)) + table_slots(n) / 2 + (n + 1) / 2);
}

// keys: n elements of elem_size (4 or 8) bytes; scratch:
// pqt_dict_indices_scratch_words 64-bit words, 16-byte aligned (its
// descriptors and table are zeroed here, on the stream); indices, firsts:
// int32[n], 16-byte aligned; n_uniques: int32[1].
extern "C" int pqt_dict_indices(const void* keys, long long n, int elem_size, void* scratch,
                                void* indices, void* firsts, void* n_uniques, void* stream) {
  if (n <= 0) return 0;
  if ((elem_size != 4 && elem_size != 8) || (uintptr_t)scratch % 16 != 0 ||
      (uintptr_t)indices % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const long long ntiles = num_tiles(n);
  const long long slots = table_slots(n);
  const long long seg_words = scan::seg_scratch_words(ntiles);
  auto* sw = (unsigned long long*)scratch;
  int32_t* table = (int32_t*)(sw + seg_words);
  int32_t* slot_of = table + slots;
  int rc = (int)cudaMemsetAsync(sw, 0, (seg_words + slots / 2) * 8, s);
  if (rc) return rc;
  if (elem_size == 4)
    insert<uint32_t><<<(unsigned)ntiles, kThreads, 0, s>>>(
        (const uint32_t*)keys, n, table, (unsigned long long)(slots - 1), slot_of);
  else
    insert<unsigned long long><<<(unsigned)ntiles, kThreads, 0, s>>>(
        (const unsigned long long*)keys, n, table, (unsigned long long)(slots - 1), slot_of);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  rank_tiles<<<(unsigned)ntiles, kThreads, 0, s>>>(
      slot_of, n, table, scan::SegTiles{sw, ntiles}, (int32_t*)indices, (int32_t*)firsts,
      (int32_t*)n_uniques);
  return (int)cudaGetLastError();
}
