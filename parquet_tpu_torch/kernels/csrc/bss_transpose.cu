// BYTE_STREAM_SPLIT de-interleave of 4-byte pages: value i of a page is the
// little-endian word of bytes streams[0][i], streams[1][i], streams[2][i],
// streams[3][i]. One launch writes up to kPages pages of a chunk, each at
// its offset in one output.
//
// Replaces parquet_tpu/kernels/device_ops.py:bss_transpose_device and its
// jitted _bss_transpose_padded (a (4, n_pad) -> (n_pad, 4) transpose and a
// bitcast under XLA), and the chunk's jnp.concatenate of the pages
// (parquet_tpu/kernels/pipeline.py). The input of a page is the (4, n_pad)
// uint8 staging the host builds (kernels/pipeline._plan_from_tables, four
// contiguous memcpys); the port writes exactly num_values words a page.
//
// Bound on an H100: memory, 8 bytes a value (four stream bytes read, one
// word written). The page table travels by value in the kernel's
// parameters (a __grid_constant__ struct: no upload), with each page's
// first block; a block finds its page by a binary search over it. A lane
// takes kSteps groups of 4 consecutive values (a warp's groups
// consecutive): one 4-byte load from each stream (128 B a warp a stream),
// a 4 x 4 byte transpose in 8 __byte_perm, one 16-byte store (512 B a
// warp). Where a page's output offset is not a multiple of 4 values, its
// first 0-3 values go one a thread and its groups start off a stream word:
// a lane loads the two stream words under its 4 bytes and funnel-shifts
// them. The parent took one thread a value (4 single-byte loads, one 4-byte
// store) and one launch a page, then a cat of the pages (PERF.md §6).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSteps = 1;  // groups of 4 values a thread
constexpr int kPages = 64;  // pages a launch: device_ops.BSS_PAGES_PER_LAUNCH
constexpr long long kBlockGroups = (long long)kThreads * kSteps;

struct Page {
  const uint8_t* streams;  // (4, n_pad) uint8
  long long n_pad;
  long long nv;
  long long out;  // the page's first output word
};

struct Table {
  Page page[kPages];
  int first_block[kPages + 1];  // the pages' first blocks, then the launch's blocks
  int pages;
};

__device__ __forceinline__ uint32_t value_at(const uint8_t* s, long long n_pad, long long i) {
  return (uint32_t)s[i] | (uint32_t)s[n_pad + i] << 8 | (uint32_t)s[2 * n_pad + i] << 16 |
         (uint32_t)s[3 * n_pad + i] << 24;
}

// 4 bytes of a stream from byte i (i - c a multiple of 4; c the page's
// misalignment, 0..3; `aligned`: the stream rows start on 4 bytes).
__device__ __forceinline__ uint32_t stream_word(const uint8_t* row, long long i, int c,
                                                bool aligned) {
  if (!aligned)
    return (uint32_t)row[i] | (uint32_t)row[i + 1] << 8 | (uint32_t)row[i + 2] << 16 |
           (uint32_t)row[i + 3] << 24;
  const uint32_t* w = reinterpret_cast<const uint32_t*>(row + (i - c));
  if (c == 0) return w[0];
  return __funnelshift_r(w[0], w[1], 8 * c);
}

__global__ void __launch_bounds__(kThreads)
    transpose(const __grid_constant__ Table t, uint32_t* __restrict__ out) {
  const int b = blockIdx.x;
  int lo = 0, hi = t.pages - 1;  // the last page whose first block is <= b
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.first_block[mid] <= b) lo = mid;
    else hi = mid - 1;
  }
  const Page pg = t.page[lo];
  const long long blk = b - t.first_block[lo];
  const uint8_t* s = pg.streams;
  uint32_t* o = out + pg.out;
  // values [0, h) before the output's first 16-byte boundary, then groups
  // of 4 from h, then a tail of nv - h - 4 * groups values
  const long long h = min((long long)((4 - (pg.out & 3)) & 3), pg.nv);
  const long long groups = (pg.nv - h) >> 2;
  if (blk == 0 && threadIdx.x < 8) {
    const long long i = threadIdx.x < 4 ? threadIdx.x : h + 4 * groups + threadIdx.x - 4;
    if (threadIdx.x < 4 ? i < h : i < pg.nv) o[i] = value_at(s, pg.n_pad, i);
  }
  const bool aligned = (uintptr_t)s % 4 == 0 && pg.n_pad % 4 == 0;
  const int c = (int)(h & 3);
  uint32_t w[kSteps][4];
#pragma unroll
  for (int k = 0; k < kSteps; ++k) {
    const long long g = blk * kBlockGroups + k * kThreads + threadIdx.x;
    if (g < groups) {
      const long long i = h + 4 * g;
#pragma unroll
      for (int r = 0; r < 4; ++r) w[k][r] = stream_word(s + r * pg.n_pad, i, c, aligned);
    }
  }
#pragma unroll
  for (int k = 0; k < kSteps; ++k) {
    const long long g = blk * kBlockGroups + k * kThreads + threadIdx.x;
    if (g < groups) {
      // byte j of stream r -> byte r of value j
      const uint32_t lo01 = __byte_perm(w[k][0], w[k][1], 0x5140);
      const uint32_t hi01 = __byte_perm(w[k][0], w[k][1], 0x7362);
      const uint32_t lo23 = __byte_perm(w[k][2], w[k][3], 0x5140);
      const uint32_t hi23 = __byte_perm(w[k][2], w[k][3], 0x7362);
      *reinterpret_cast<uint4*>(o + h + 4 * g) =
          make_uint4(__byte_perm(lo01, lo23, 0x5410), __byte_perm(lo01, lo23, 0x7632),
                     __byte_perm(hi01, hi23, 0x5410), __byte_perm(hi01, hi23, 0x7632));
    }
  }
}

}  // namespace

// table: int64[pages][3], each page's (streams pointer, n_pad, num_values),
// num_values >= 1; out: uint32[sum of num_values], 16-byte aligned, the
// pages' values one after another. One launch each kPages pages.
extern "C" int pqt_bss_transpose_pages(const void* table, int pages, void* out, void* stream) {
  if (pages < 0 || (uintptr_t)out % 16 != 0) return (int)cudaErrorInvalidValue;
  const long long* rows = (const long long*)table;
  const cudaStream_t st = (cudaStream_t)stream;
  long long off = 0;
  for (int base = 0; base < pages; base += kPages) {
    Table t;
    t.pages = pages - base < kPages ? pages - base : kPages;
    long long blocks = 0;
    for (int p = 0; p < t.pages; ++p) {
      const long long* r = rows + 3 * (long long)(base + p);
      if (r[2] <= 0 || r[2] > r[1]) return (int)cudaErrorInvalidValue;
      t.page[p] = {(const uint8_t*)r[0], r[1], r[2], off};
      t.first_block[p] = (int)blocks;
      const long long groups = r[2] / 4;  // at least (nv - 3) / 4 groups, at most nv / 4
      blocks += groups > 0 ? (groups + kBlockGroups - 1) / kBlockGroups : 1;
      off += r[2];
    }
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    t.first_block[t.pages] = (int)blocks;
    transpose<<<(unsigned)blocks, kThreads, 0, st>>>(t, (uint32_t*)out);
    const int rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  return 0;
}
