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
// One scan.cuh scan over int64 items that pack the two counts, the
// boundary flag in the high 32 bits and the element flag in the low 32
// (both counts stay below 2^31, so the low half never carries). The
// epilogue writes, for a boundary entry i of slot k, offsets[k] and
// first_def[k]; for every index i >= n_slots, the padding offsets[i] and
// first_def[i]; and in the last thread offsets[n] and n_slots. Every
// output slot has exactly one writer, so the result is deterministic.
//
// Bound on an H100: memory. Bytes: rep and dfl read once, offsets and
// first_def written once (16 B per entry); beyond that the scan writes and
// reads its 8-byte partial per entry, and the epilogue reads rep and dfl
// again.

#include "scan.cuh"

namespace {

struct Flags {
  const int32_t* rep;
  const int32_t* dfl;
  long long parent_rep, elem_def;
  __device__ bool boundary(long long i) const { return (long long)rep[i] <= parent_rep; }
  __device__ bool elem(long long i) const {
    return (long long)rep[i] <= parent_rep + 1 && (long long)dfl[i] >= elem_def;
  }
  __device__ long long operator()(long long i) const {
    return ((long long)boundary(i) << 32) | (long long)elem(i);
  }
};

struct Layout {
  Flags f;
  long long n;
  int32_t* offsets;
  int32_t* first_def;
  long long* n_slots_out;
  __device__ void operator()(long long i, long long incl, long long total) const {
    const long long n_slots = total >> 32;
    const long long e_total = total & 0xffffffffll;
    if (f.boundary(i)) {
      const long long k = (incl >> 32) - 1;
      const long long e_before = (incl & 0xffffffffll) - (long long)f.elem(i);
      first_def[k] = f.dfl[i];
      offsets[k] = k == 0 ? 0 : (int32_t)e_before;
    }
    if (i >= n_slots) {
      first_def[i] = 0;
      offsets[i] = i == 0 ? 0 : (int32_t)e_total;
    }
    if (i == n - 1) {
      offsets[n] = (int32_t)e_total;
      *n_slots_out = n_slots;
    }
  }
};

}  // namespace

extern "C" int pqt_list_layout(const void* rep, const void* dfl, long long n,
                               long long parent_rep, long long elem_def,
                               void* offsets, void* first_def, void* n_slots,
                               void* partial, void* tile_sums, void* stream) {
  const Flags f{(const int32_t*)rep, (const int32_t*)dfl, parent_rep, elem_def};
  return scan::run<long long>(
      f, Layout{f, n, (int32_t*)offsets, (int32_t*)first_def, (long long*)n_slots},
      n, (long long*)partial, (long long*)tile_sums, (cudaStream_t)stream);
}
