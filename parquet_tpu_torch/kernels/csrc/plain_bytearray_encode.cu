// PLAIN framing of a byte-array column: `<4-byte LE length><bytes>` per
// value, value i's frame at s(i) = 4*i + off[i] - off[0], the stream
// total = s(n) bytes long, zeros from there to out_len.
//
// Replaces parquet_tpu/kernels/device_ops.py:plain_bytearray_encode_device
// (under XLA: a searchsorted of every output byte into the framed value
// starts, then header bytes from the offset diffs and payload bytes gathered
// out of `data`, into a zero-padded bucket).
//
// Output-stationary, in two launches:
//
//   1. tile_heads: one thread a value names itself the head of every tile of
//      kTileBytes output bytes whose first byte its frame holds (s rises by
//      at least 4 a value, so each tile has one head);
//   2. frame: each block owns one tile, 16-byte aligned, and writes every
//      byte of it, zeros past the stream included (the wrapper allocates
//      with torch.empty: no zero fill). It stages the starts and lengths of
//      the at most kTileBytes / 4 + 2 values from its head to the next
//      tile's in shared memory, and each value names the 16-byte chunks
//      whose first byte it holds. Each thread then assembles one chunk word
//      by word: the at most 5 frames over it place their header bytes, and
//      its payload bytes, one run of data, come from the 6 aligned 4-byte
//      words over that run through funnel shifts (the payload bytes of one
//      output word share one frame). One 16-byte store; the output's last
//      partial chunk byte by byte.
//
// Positions inside a tile are 32-bit, relative to the tile's first byte;
// the tile's own position and the data addresses are 64-bit (offsets are
// int64).
//
// Bound on an H100: memory. Bytes: the offsets read (8 B per value), the
// data read once and the stream written once (data + 4 B per value). Beyond
// them: the offsets read again by the tiles (from L2) and 4 B of head a
// tile. At taxi zone group 0 (1,048,576 values of 12-22 bytes, 17,826,177
// bytes, a 22,020,481-byte stream) this takes about 0.034 ms against a
// 0.0144 ms bound on an H100 80GB HBM3 at 700 W, where the former kernel
// (one thread a value storing its bytes one at a time, after a zero fill)
// took 0.171 (PERF.md §6). Why this shape, measured there: a warp's
// 32-ary search of s for each tile's head, in place of tile_heads, took
// 0.056 ms against 0.044 with the same byte-at-a-time assembly, and that
// assembly 0.044 against 0.034 for words; staging the tile's data span in
// shared memory lost to direct reads in every A/B.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileBytes = 16 * kThreads;       // device_ops.FRAME_TILE
constexpr int kMaxValues = kTileBytes / 4 + 2;  // frames a tile stages (one past its last)

struct Frames {
  const uint8_t* data;
  const long long* off;
  long long n;
  long long out_len;
  uint8_t* out;
};

// heads[t] = the value whose frame holds tile t's first byte, for every tile
// t < ntiles that starts inside the stream: one thread a value.
__global__ void tile_heads(const long long* __restrict__ off, long long n, long long ntiles,
                           int32_t* __restrict__ heads) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const long long off0 = __ldg(off);
  const long long a = 4 * i + __ldg(off + i) - off0, b = 4 * (i + 1) + __ldg(off + i + 1) - off0;
  for (long long t = (a + kTileBytes - 1) / kTileBytes; t < ntiles && t * kTileBytes < b; ++t)
    heads[t] = (int32_t)i;
}

// Bits [a, b) of a 16-bit chunk mask (a, b clipped to [0, 16]).
__device__ __forceinline__ uint32_t bit_range(int a, int b) {
  a = max(a, 0);
  b = min(b, 16);
  return a < b ? ((1u << b) - 1u) & ~((1u << a) - 1u) : 0u;
}

// 0xFF in byte b of the word for each bit b of a 4-bit mask (the multiply
// spreads the bits 7 apart, so no two products meet).
__device__ __forceinline__ uint32_t byte_mask(uint32_t bits) {
  return ((bits * 0x204081u) & 0x01010101u) * 0xFFu;
}

// ORs the 4 little-endian bytes of v into chunk bytes p .. p + 3 (p > -4; the
// bytes outside [0, 16) drop), the chunk as 128 bits (lo, hi).
__device__ __forceinline__ void put4(unsigned long long& lo, unsigned long long& hi, uint32_t v,
                                     int p) {
  if (p < 0) {
    lo |= v >> (-8 * p);
  } else if (p < 8) {
    lo |= (unsigned long long)v << (8 * p);
    if (p > 4) hi |= v >> (64 - 8 * p);
  } else {
    hi |= (unsigned long long)v << (8 * (p - 8));
  }
}

// At most 32 registers a thread, so that 8 blocks fit an SM: a tile's time is
// a chain of dependent loads, and occupancy hides it.
__global__ void __launch_bounds__(kThreads, 2048 / kThreads)
    frame(Frames f, const int32_t* __restrict__ heads) {
  // the frames' starts relative to the tile's first byte (clamped to
  // +-2^30: only compares with positions inside the tile read them), the
  // low 32 bits of the values' lengths, and the frame holding each
  // thread's first byte
  __shared__ int32_t s_start[kMaxValues + 1];
  __shared__ uint32_t s_len[kMaxValues];
  __shared__ int16_t s_frame[kThreads];

  const long long ntiles = gridDim.x;
  const long long off0 = __ldg(f.off);
  const long long total = 4 * f.n + __ldg(f.off + f.n) - off0;
  const long long base = (long long)blockIdx.x * kTileBytes;
  const long long end = min(base + (long long)kTileBytes, f.out_len);
  const int live = (int)max(min(end, total) - base, 0ll);  // tile bytes below it are stream bytes
  long long v0 = 0;
  int m = 0;
  if (live > 0) {
    // frames v0 .. v0 + m - 1: the tile's first and the one holding the next
    // tile's first byte (or the last); the clamps only keep non-rising
    // offsets inside the staging
    v0 = __ldg(heads + blockIdx.x);
    const long long v1 = blockIdx.x + 1 < ntiles && base + kTileBytes < total
                             ? (long long)__ldg(heads + blockIdx.x + 1)
                             : f.n - 1;
    m = (int)max(min(min(v1 - v0 + 1, (long long)kMaxValues), f.n - v0), 1ll);
    for (int k = threadIdx.x; k <= m; k += kThreads) {
      const long long o = __ldg(f.off + v0 + k);
      const long long rel = 4 * (v0 + k) + o - off0 - base;
      s_start[k] = (int32_t)max(min(rel, 1ll << 30), -(1ll << 30));
      if (k < m) s_len[k] = (uint32_t)(__ldg(f.off + v0 + k + 1) - o);
    }
    __syncthreads();
    // each frame names the 16-byte chunks whose first byte it holds
    for (int k = threadIdx.x; k < m; k += kThreads) {
      const int c1 = min((s_start[k + 1] + 15) >> 4, kThreads);
      for (int c = max((s_start[k] + 15) >> 4, 0); c < c1; ++c) s_frame[c] = (int16_t)k;
    }
    __syncthreads();
  }

  const int r0 = 16 * threadIdx.x;  // the thread's first byte in the tile
  if (base + r0 >= end) return;
  uint32_t w[4] = {0u, 0u, 0u, 0u};  // the 16 bytes, little-endian
  if (r0 < live) {
    const int k0 = s_frame[threadIdx.x];
    const int lim = min(live - r0, 16);  // the chunk's stream bytes
    const uint32_t in = (2u << (lim - 1)) - 1u;
    // the at most 5 frames overlapping the chunk (each at least 4 bytes): their
    // header bytes placed, header positions and later frames' starts marked
    unsigned long long lo = 0, hi = 0;
    uint32_t hdr = 0, starts = 0;
#pragma unroll
    for (int u = 0; u < 5; ++u) {
      const int p = k0 + u < m ? s_start[k0 + u] - r0 : 16;
      if (u > 0) {
        if (p >= lim) break;
        starts |= 1u << p;
      }
      if (p > -4) {
        put4(lo, hi, s_len[k0 + u], p);
        hdr |= bit_range(p, p + 4);
      }
    }
    w[0] = (uint32_t)lo;
    w[1] = (uint32_t)(lo >> 32);
    w[2] = (uint32_t)hi;
    w[3] = (uint32_t)(hi >> 32);
    const uint32_t pay = in & ~hdr;
    if (pay) {
      // chunk byte q of frame k0 + t is payload byte data[d + q - 4 t], and the
      // chunk's payload bytes are one run of data, [dlo, dhi): load the
      // aligned words over it, Y[v] = data[d + 4 (v - 1) ..] funnelled
      const uintptr_t d = (uintptr_t)f.data + (uintptr_t)(base + off0 - 4 * (v0 + k0 + 1) + r0);
      const int qf = __ffs(pay) - 1, ql = 31 - __clz(pay);
      const uintptr_t dlo = d + qf - 4 * __popc(starts & ((2u << qf) - 1u));
      const uintptr_t dhi = d + ql - 4 * __popc(starts & ((2u << ql) - 1u)) + 1;
      const uintptr_t a0 = (d & ~(uintptr_t)3) - 4;
      uint32_t a[6];
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        const uintptr_t at = a0 + 4 * j;
        a[j] = at < dhi && at + 4 > dlo ? __ldg(reinterpret_cast<const uint32_t*>(at)) : 0u;
      }
      const int sh = 8 * (int)(d & 3);
      uint32_t y[5];
#pragma unroll
      for (int v = 0; v < 5; ++v) y[v] = __funnelshift_r(a[v], a[v + 1], sh);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t pm = pay >> (4 * i) & 0xFu;
        if (pm) {
          // a word's payload bytes share one frame: t <= i + 1
          const int q = 4 * i + __ffs(pm) - 1;
          const int v = i + 1 - __popc(starts & ((2u << q) - 1u));
          const uint32_t x = v == 0 ? y[0] : v == 1 ? y[1] : v == 2 ? y[2] : v == 3 ? y[3] : y[4];
          w[i] |= x & byte_mask(pm);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] &= byte_mask(in >> (4 * i) & 0xFu);
  }
  uint8_t* out = f.out + base + r0;
  if (base + r0 + 16 <= end) {
    *reinterpret_cast<uint4*>(out) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int q = 0; q < 16; ++q)
      if (base + r0 + q < end) out[q] = (uint8_t)(w[q >> 2] >> (8 * (q & 3)));
  }
}

}  // namespace

// data: uint8; offsets: int64[n + 1], non-decreasing, n < 2^31; out:
// uint8[out_len], 16-byte aligned, every byte written; scratch: one int32
// a tile (ceil(out_len / kTileBytes)), the tiles' first values.
extern "C" int pqt_plain_bytearray_encode(const void* data, const void* offsets, long long n,
                                          long long out_len, void* out, void* scratch,
                                          void* stream) {
  if (out_len <= 0) return 0;
  if (n < 0 || n > INT_MAX || (uintptr_t)out % 16 != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const long long ntiles = (out_len + kTileBytes - 1) / kTileBytes;
  if (n > 0) {
    tile_heads<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, s>>>(
        (const long long*)offsets, n, ntiles, (int32_t*)scratch);
    const int rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  Frames f{(const uint8_t*)data, (const long long*)offsets, n, out_len, (uint8_t*)out};
  frame<<<(unsigned)ntiles, kThreads, 0, s>>>(f, (const int32_t*)scratch);
  return (int)cudaGetLastError();
}
