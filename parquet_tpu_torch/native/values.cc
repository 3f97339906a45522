// Host value functions of parquet_tpu_torch: the per-value loops of the
// host read and write paths, as one C pass each.
//
// A cut-down copy of the JAX package's native/parquet_tpu_native.cc (the
// port carries its own copy and never loads that library): XXH64 (the bloom
// probe's hash), the PLAIN byte-array gather and encode, the byte-array
// take, the one-shot hybrid RLE/bit-pack decode and encode, the full
// DELTA_BINARY_PACKED decode with its header probe, the byte-array min/max
// and the byte-array and numeric dictionary probes. Each function is the
// original's, byte for byte in what it returns; the bloom batch hashes and
// inserts, gzip compression and the fused encode walk are left out.
//
// Linked with prepare.cc into one library (libpqt_host.so) by
// parquet_tpu_torch/kernels/host_build.py and bound with ctypes in
// parquet_tpu_torch/utils/native.py. All functions validate sizes before
// writing and return a negative code on bad input.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cstddef>
#include <sys/types.h>  // ssize_t

#include "bits.h"  // bit reader/writer and varints (shared with prepare.cc)

extern "C" {

// ---------------------------------------------------------------------------
// XXH64 (the split-block bloom filter's hash, parquet-format BloomFilter.md)
//
// Implemented from the public xxHash specification.
// ---------------------------------------------------------------------------

static const uint64_t XP1 = 0x9E3779B185EBCA87ull;
static const uint64_t XP2 = 0xC2B2AE3D27D4EB4Full;
static const uint64_t XP3 = 0x165667B19E3779F9ull;
static const uint64_t XP4 = 0x85EBCA77C2B2AE63ull;
static const uint64_t XP5 = 0x27D4EB2F165667C5ull;

static inline uint64_t xrotl(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

static inline uint64_t xread64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;  // little-endian hosts only (matches the rest of this file)
}

static inline uint32_t xread32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

uint64_t ptq_xxh64(const uint8_t* p, size_t len, uint64_t seed) {
  const uint8_t* end = p + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = seed + XP1 + XP2, v2 = seed + XP2, v3 = seed, v4 = seed - XP1;
    const uint8_t* limit = end - 32;
    do {
      v1 = xrotl(v1 + xread64(p) * XP2, 31) * XP1;
      v2 = xrotl(v2 + xread64(p + 8) * XP2, 31) * XP1;
      v3 = xrotl(v3 + xread64(p + 16) * XP2, 31) * XP1;
      v4 = xrotl(v4 + xread64(p + 24) * XP2, 31) * XP1;
      p += 32;
    } while (p <= limit);
    h = xrotl(v1, 1) + xrotl(v2, 7) + xrotl(v3, 12) + xrotl(v4, 18);
    h = (h ^ (xrotl(v1 * XP2, 31) * XP1)) * XP1 + XP4;
    h = (h ^ (xrotl(v2 * XP2, 31) * XP1)) * XP1 + XP4;
    h = (h ^ (xrotl(v3 * XP2, 31) * XP1)) * XP1 + XP4;
    h = (h ^ (xrotl(v4 * XP2, 31) * XP1)) * XP1 + XP4;
  } else {
    h = seed + XP5;
  }
  h += static_cast<uint64_t>(len);
  while (p + 8 <= end) {
    h = xrotl(h ^ (xrotl(xread64(p) * XP2, 31) * XP1), 27) * XP1 + XP4;
    p += 8;
  }
  if (p + 4 <= end) {
    h = xrotl(h ^ (static_cast<uint64_t>(xread32(p)) * XP1), 23) * XP2 + XP3;
    p += 4;
  }
  while (p < end) {
    h = xrotl(h ^ (static_cast<uint64_t>(*p) * XP5), 11) * XP1;
    p++;
  }
  h ^= h >> 33;
  h *= XP2;
  h ^= h >> 29;
  h *= XP3;
  h ^= h >> 32;
  return h;
}

// ---------------------------------------------------------------------------
// PLAIN byte_array scan: 4-byte LE length + payload, repeated
// ---------------------------------------------------------------------------

// Fills offsets[0..num_values] (compacted) and copies payloads into data_out.
// Returns bytes consumed from src, or -1 on corrupt input / overflow.
ssize_t ptq_byte_array_gather(const char* src, size_t src_len, int64_t num_values,
                              int64_t* offsets, char* data_out, size_t data_cap) {
  size_t pos = 0;
  int64_t total = 0;
  offsets[0] = 0;
  for (int64_t i = 0; i < num_values; i++) {
    if (pos + 4 > src_len) return -1;
    uint32_t len;
    std::memcpy(&len, src + pos, 4);  // little-endian hosts only (x86/arm64)
    pos += 4;
    if (pos + len > src_len) return -1;
    if (static_cast<size_t>(total) + len > data_cap) return -1;
    std::memcpy(data_out + total, src + pos, len);
    pos += len;
    total += len;
    offsets[i + 1] = total;
  }
  return static_cast<ssize_t>(pos);
}

// ---------------------------------------------------------------------------
// one-shot hybrid RLE/bit-pack decode (prescan + expand fused, host hot path)
// ---------------------------------------------------------------------------

// Decodes `num_values` into out32 or out64 (exactly one non-null). Returns
// bytes consumed, or -1 on corrupt input. Semantics mirror prescan_hybrid +
// expand_runs in ops/rle_hybrid.py (the NumPy reference implementation).
ssize_t ptq_hybrid_decode(const uint8_t* src, size_t src_len, int64_t num_values,
                          int width, uint32_t* out32, uint64_t* out64) {
  if (width < 0 || width > 64) return -1;
  if (width > 32 && out32) return -1;
  const size_t vbytes = (width + 7) / 8;
  size_t pos = 0;
  int64_t produced = 0;
  while (produced < num_values) {
    uint64_t header = 0;
    int shift = 0;
    for (;;) {
      if (pos >= src_len || shift > 63) return -1;
      uint8_t b = src[pos++];
      if (shift == 63 && (b & 0x7e)) return -1;  // overflows uint64
      header |= static_cast<uint64_t>(b & 0x7f) << shift;
      if (!(b & 0x80)) break;
      shift += 7;
    }
    if (header & 1) {
      uint64_t groups = header >> 1;
      if (groups == 0 || groups > (1ull << 40)) return -1;
      uint64_t count = groups * 8;
      uint64_t nbytes = groups * static_cast<uint64_t>(width);
      if (pos + nbytes > src_len) return -1;
      int64_t take = num_values - produced;
      if (static_cast<uint64_t>(take) > count) take = static_cast<int64_t>(count);
      BitReader r;
      br_init(&r, src + pos, nbytes);
      if (out32) {
        for (int64_t i = 0; i < take; i++) out32[produced + i] = static_cast<uint32_t>(br_read(&r, width));
      } else {
        for (int64_t i = 0; i < take; i++) out64[produced + i] = br_read(&r, width);
      }
      pos += nbytes;
      produced += take;
    } else {
      uint64_t count = header >> 1;
      if (count == 0 || count > (1ull << 40) || pos + vbytes > src_len) return -1;
      uint64_t v = 0;
      for (size_t i = 0; i < vbytes; i++) v |= static_cast<uint64_t>(src[pos + i]) << (8 * i);
      if (width < 64 && v >= (1ull << width)) return -1;
      pos += vbytes;
      int64_t take = num_values - produced;
      if (static_cast<uint64_t>(take) > count) take = static_cast<int64_t>(count);
      if (out32) {
        uint32_t v32 = static_cast<uint32_t>(v);
        for (int64_t i = 0; i < take; i++) out32[produced + i] = v32;
      } else {
        for (int64_t i = 0; i < take; i++) out64[produced + i] = v;
      }
      produced += take;
    }
  }
  return static_cast<ssize_t>(pos);
}

// ---------------------------------------------------------------------------
// DELTA_BINARY_PACKED decode (header walk + miniblock unpack + wrapping cumsum)
// ---------------------------------------------------------------------------

// Full decode of a DELTA_BINARY_PACKED stream into out (int32 when nbits==32,
// int64 when nbits==64; the buffer must hold the header's value count, which
// is bounded by max_total). Returns bytes consumed, -1 on corrupt input, -3
// if the stream's count exceeds max_total (validation-before-allocation: the
// caller probes the count first via ptq_delta_peek_total).
// Semantics mirror ops/delta.py prescan_delta + decode_delta exactly,
// including wrapping min-delta arithmetic (reference: deltabp_encoder.go:58-61)
// and trailing-miniblock payload rules (reference: deltabp_decoder.go flush()).
ssize_t ptq_delta_decode(const uint8_t* src, size_t src_len, int nbits,
                         int64_t max_total, void* out_v, int64_t* total_out) {
  if (nbits != 32 && nbits != 64) return -1;
  size_t pos = 0;
  uint64_t block_size, mini_count, total_u;
  if (!read_uvarint64(src, src_len, &pos, &block_size)) return -1;
  if (!read_uvarint64(src, src_len, &pos, &mini_count)) return -1;
  if (!read_uvarint64(src, src_len, &pos, &total_u)) return -1;
  uint64_t first_zz;
  if (!read_uvarint64(src, src_len, &pos, &first_zz)) return -1;
  uint64_t first = (first_zz >> 1) ^ (~(first_zz & 1) + 1);  // zigzag decode
  if (block_size == 0 || block_size % 128 != 0 || block_size > (1ull << 20)) return -1;
  if (mini_count == 0 || mini_count > 512 || block_size % mini_count != 0) return -1;
  uint64_t mini_len = block_size / mini_count;
  if (mini_len % 8 != 0) return -1;
  int64_t total = static_cast<int64_t>(total_u);
  if (total_u > (1ull << 62)) return -1;
  if (max_total >= 0 && total > max_total) return -3;
  // plausibility backstop (parity with prescan_delta)
  uint64_t plausible = 1 + (src_len / (1 + mini_count) + 1) * block_size;
  if (total_u > plausible) return -3;
  *total_out = total;

  const uint64_t mask = (nbits == 64) ? ~0ull : ((1ull << nbits) - 1);
  int32_t* out32 = (nbits == 32) ? static_cast<int32_t*>(out_v) : nullptr;
  int64_t* out64 = (nbits == 64) ? static_cast<int64_t*>(out_v) : nullptr;
  uint64_t acc = first & mask;
  if (total > 0) {
    if (out32) out32[0] = static_cast<int32_t>(static_cast<uint32_t>(acc));
    else out64[0] = static_cast<int64_t>(acc);
  }
  int64_t n_deltas = total > 1 ? total - 1 : 0;
  int64_t produced = 0;
  while (produced < n_deltas) {
    uint64_t md_zz;
    if (!read_uvarint64(src, src_len, &pos, &md_zz)) return -1;
    uint64_t min_delta = (md_zz >> 1) ^ (~(md_zz & 1) + 1);
    if (pos + mini_count > src_len) return -1;
    const uint8_t* widths = src + pos;
    pos += mini_count;
    for (uint64_t m = 0; m < mini_count; m++) {
      int64_t remaining = n_deltas - produced;
      if (remaining <= 0) continue;  // unused trailing miniblock: no payload
      int w = widths[m];
      if (w > nbits) return -1;
      uint64_t payload = (mini_len / 8) * static_cast<uint64_t>(w);
      if (pos + payload > src_len) return -1;
      int64_t take = remaining < static_cast<int64_t>(mini_len)
                         ? remaining : static_cast<int64_t>(mini_len);
      BitReader r;
      br_init(&r, src + pos, payload);
      if (out32) {
        uint32_t a = static_cast<uint32_t>(acc);
        uint32_t md32 = static_cast<uint32_t>(min_delta);
        for (int64_t i = 0; i < take; i++) {
          a += static_cast<uint32_t>(br_read(&r, w)) + md32;
          out32[produced + 1 + i] = static_cast<int32_t>(a);
        }
        acc = a;
      } else {
        uint64_t a = acc;
        for (int64_t i = 0; i < take; i++) {
          a += br_read(&r, w) + min_delta;
          out64[produced + 1 + i] = static_cast<int64_t>(a);
        }
        acc = a;
      }
      pos += payload;
      produced += take;
    }
  }
  return static_cast<ssize_t>(pos);
}

// Header probe for pre-allocation: validates the full header (same rules as
// ptq_delta_decode, including the plausibility backstop that bounds the value
// count by the stream length — validation-before-allocation) and returns the
// value count. Returns 0 on success, -1 on corrupt/implausible header.
ssize_t ptq_delta_peek_total(const uint8_t* src, size_t src_len, int64_t* total) {
  size_t pos = 0;
  uint64_t bs, mc, t, fz;
  if (!read_uvarint64(src, src_len, &pos, &bs)) return -1;
  if (!read_uvarint64(src, src_len, &pos, &mc)) return -1;
  if (!read_uvarint64(src, src_len, &pos, &t)) return -1;
  if (!read_uvarint64(src, src_len, &pos, &fz)) return -1;
  if (bs == 0 || bs % 128 != 0 || bs > (1ull << 20)) return -1;
  if (mc == 0 || mc > 512 || bs % mc != 0) return -1;
  if ((bs / mc) % 8 != 0) return -1;
  if (t > (1ull << 62)) return -1;
  uint64_t plausible = 1 + (src_len / (1 + mc) + 1) * bs;
  if (t > plausible) return -1;
  *total = static_cast<int64_t>(t);
  return 0;
}

// ---------------------------------------------------------------------------
// byte-array dictionary gather (ByteArrayData.take hot path)
// ---------------------------------------------------------------------------

// out must hold sum of the gathered lengths (caller computes via new_offsets,
// which it builds with a NumPy cumsum). Returns 0, or -1 on a bad index.
ssize_t ptq_bytearray_take(const char* data, size_t data_len,
                           const int64_t* offsets, int64_t n_src,
                           const int64_t* indices, int64_t n_idx,
                           const int64_t* new_offsets, char* out, size_t out_cap) {
  for (int64_t k = 0; k < n_idx; k++) {
    int64_t i = indices[k];
    if (i < 0 || i >= n_src) return -1;
    int64_t start = offsets[i];
    int64_t len = offsets[i + 1] - start;
    int64_t dst = new_offsets[k];
    if (start < 0 || len < 0 || static_cast<size_t>(start + len) > data_len ||
        static_cast<size_t>(dst + len) > out_cap)
      return -1;
    std::memcpy(out + dst, data + start, len);
  }
  return 0;
}

// PLAIN BYTE_ARRAY encode: [4B LE length][bytes] per value, straight from
// an (offsets, data) column — the write path's hot loop for string chunks.
// out must hold data_len + 4*n bytes.
ssize_t ptq_plain_encode_bytearray(const char* data, size_t data_len,
                                   const int64_t* offsets, int64_t n,
                                   char* out, size_t out_cap) {
  size_t pos = 0;
  for (int64_t i = 0; i < n; i++) {
    int64_t start = offsets[i];
    int64_t len = offsets[i + 1] - start;
    if (start < 0 || len < 0 || static_cast<size_t>(start + len) > data_len)
      return -1;
    if (len > static_cast<int64_t>(UINT32_MAX)) return -1;  // 4B prefix cap
    if (pos + 4 + static_cast<size_t>(len) > out_cap) return -1;
    uint32_t l32 = static_cast<uint32_t>(len);
    std::memcpy(out + pos, &l32, 4);
    std::memcpy(out + pos + 4, data + start, static_cast<size_t>(len));
    pos += 4 + static_cast<size_t>(len);
  }
  return static_cast<ssize_t>(pos);
}

// ---------------------------------------------------------------------------
// hybrid RLE/bit-pack encode (the write path's level and index streams)
// ---------------------------------------------------------------------------

namespace {

// One bit-packed segment: header (groups<<1)|1 then LSB-first payload,
// zero-padding the final partial group (mirrors _emit_bitpacked). The
// original reads 2-, 4- or 8-byte elements for its fused encode walk; the
// port has no such walk, so this copy reads uint64 only.
static bool emit_bitpacked(const uint64_t* v, int64_t n, int width,
                           uint8_t* out, size_t cap, size_t* pos,
                           bool* bad_value) {
  if (n == 0) return true;
  int64_t padded = (n + 7) & ~7ll;
  if (!put_uvarint(out, cap, pos, ((static_cast<uint64_t>(padded) / 8) << 1) | 1))
    return false;
  if (width <= 16) {
    // fast lane for the common widths (levels and dictionary indices):
    // a full group of 8 values occupies exactly `width` bytes, and 8*16
    // bits fit one 128-bit accumulator — pack per GROUP with a single
    // bounds check and byte-store loop instead of per-value bit pushes
    size_t p = *pos;
    if (p + static_cast<size_t>((padded / 8)) * width > cap) return false;
    int64_t full = n & ~7ll;
    const uint64_t lim = 1ull << width;
    for (int64_t g = 0; g < full; g += 8) {
      unsigned __int128 acc = 0;
      uint64_t over = 0;
      for (int k = 0; k < 8; k++) {
        uint64_t x = v[g + k];
        over |= x;
        acc |= static_cast<unsigned __int128>(x) << (k * width);
      }
      if (over >= lim) { *bad_value = true; return false; }
      for (int b = 0; b < width; b++) {
        out[p++] = static_cast<uint8_t>(acc);
        acc >>= 8;
      }
    }
    if (full < n) {  // trailing partial group, zero-padded to 8
      unsigned __int128 acc = 0;
      for (int64_t i = full; i < n; i++) {
        uint64_t x = v[i];
        if (x >= lim) { *bad_value = true; return false; }
        acc |= static_cast<unsigned __int128>(x) << ((i - full) * width);
      }
      for (int b = 0; b < width; b++) {
        out[p++] = static_cast<uint8_t>(acc);
        acc >>= 8;
      }
    }
    *pos = p;
    return true;
  }
  BitWriter w;
  bw_init(&w, out, cap, *pos);
  for (int64_t i = 0; i < n; i++) {
    uint64_t x = v[i];
    if (width < 64 && (x >> width)) { *bad_value = true; return false; }
    if (!bw_push(&w, x, width)) return false;
  }
  for (int64_t i = n; i < padded; i++)
    if (!bw_push(&w, 0, width)) return false;
  if (!bw_flush(&w)) return false;
  *pos = w.pos;
  return true;
}

}  // namespace

// Hybrid RLE/bit-pack encode of uint64 values at `width` bits. 8-aligned
// stretches of >=8 identical values become RLE runs, everything else is
// bit-packed in groups of 8 (mirrors ops/rle_hybrid.py encode_hybrid
// byte-for-byte). Returns bytes written, -1 on a value that does not fit
// the width, -2 if out_cap is too small.
ssize_t ptq_hybrid_encode(const uint64_t* vals, int64_t n, int width,
                          uint8_t* out, size_t out_cap) {
  if (width < 0 || width > 64 || n < 0) return -1;
  size_t pos = 0;
  if (n == 0) return 0;
  if (width == 0) {
    if (!put_uvarint(out, out_cap, &pos, static_cast<uint64_t>(n) << 1)) return -2;
    return static_cast<ssize_t>(pos);
  }
  const int vbytes = (width + 7) / 8;
  bool bad = false;
  int64_t i = 0;
  int64_t seg = 0;  // start of the pending bit-packed segment
  while (i < n) {
    int64_t j = i + 1;
    const uint64_t cur = vals[i];
    while (j < n && vals[j] == cur) j++;
    if (j - i >= 8) {
      // 8-align the RLE window so surrounding bit-packed segments stay
      // multiples of 8 values (mid-stream padding would shift the stream)
      int64_t rle_start = (i + 7) & ~7ll;
      int64_t rle_end = j & ~7ll;
      if (rle_end - rle_start >= 8) {
        if (rle_start > seg &&
            !emit_bitpacked(vals + seg, rle_start - seg, width, out, out_cap,
                            &pos, &bad))
          return bad ? -1 : -2;
        if (width < 64 && (cur >> width)) return -1;
        if (!put_uvarint(out, out_cap, &pos,
                         static_cast<uint64_t>(rle_end - rle_start) << 1))
          return -2;
        if (pos + vbytes > out_cap) return -2;
        for (int b = 0; b < vbytes; b++)
          out[pos++] = static_cast<uint8_t>(cur >> (8 * b));
        seg = rle_end;
      }
    }
    i = j;
  }
  if (seg < n &&
      !emit_bitpacked(vals + seg, n - seg, width, out, out_cap, &pos, &bad))
    return bad ? -1 : -2;
  return static_cast<ssize_t>(pos);
}

// ---------------------------------------------------------------------------
// byte-array statistics and dictionary probes (the write path's chunk build)
// ---------------------------------------------------------------------------

// Dictionary build over an (offsets, data) byte-array column: open-addressed
// FNV-1a hash, first-occurrence unique order (parity with the Python dict
// loop, core/column_store.py). Fills indices[n] and firsts[<=max_uniques+1] (row
// of each unique's first occurrence). Returns the unique count, -2 when it
// exceeds max_uniques (dictionary encoding does not pay), -1 bad input /
// allocation failure.
ssize_t ptq_bytes_dict_indices(const char* data, size_t data_len,
                               const int64_t* offsets, int64_t n,
                               int64_t max_uniques, uint32_t* indices,
                               uint32_t* firsts) {
  if (n < 0 || max_uniques < 0) return -1;
  if (n == 0) return 0;
  // table sized for the unique cap, not n: a high-cardinality column bails
  // out early without a giant allocation
  size_t want = static_cast<size_t>(
      (max_uniques + 2) < n ? (max_uniques + 2) : n);
  size_t tsize = 64;
  while (tsize < want * 2) tsize <<= 1;
  uint32_t* table = static_cast<uint32_t*>(malloc(tsize * sizeof(uint32_t)));
  if (!table) return -1;
  std::memset(table, 0xff, tsize * sizeof(uint32_t));  // 0xffffffff = empty
  const size_t tmask = tsize - 1;
  int64_t uniques = 0;
  for (int64_t i = 0; i < n; i++) {
    int64_t off = offsets[i];
    int64_t len = offsets[i + 1] - off;
    if (off < 0 || len < 0 || static_cast<size_t>(off + len) > data_len) {
      free(table);
      return -1;
    }
    const uint8_t* p = reinterpret_cast<const uint8_t*>(data + off);
    uint64_t h = 1469598103934665603ull;
    for (int64_t b = 0; b < len; b++) h = (h ^ p[b]) * 1099511628211ull;
    size_t slot = static_cast<size_t>(h) & tmask;
    for (;;) {
      uint32_t uid = table[slot];
      if (uid == 0xffffffffu) {
        if (uniques >= max_uniques) {  // would exceed the cutoff: no dict
          free(table);
          return -2;
        }
        table[slot] = static_cast<uint32_t>(uniques);
        firsts[uniques] = static_cast<uint32_t>(i);
        indices[i] = static_cast<uint32_t>(uniques);
        uniques++;
        break;
      }
      int64_t fo = offsets[firsts[uid]];
      int64_t flen = offsets[firsts[uid] + 1] - fo;
      if (flen == len && std::memcmp(data + fo, data + off, len) == 0) {
        indices[i] = uid;
        break;
      }
      slot = (slot + 1) & tmask;
    }
  }
  free(table);
  return static_cast<ssize_t>(uniques);
}

// Lexicographic min/max over an (offsets, data) byte-array column.
// out[0]/out[1] = row index of min/max. Returns 0, -1 on bad input / n == 0.
ssize_t ptq_bytes_minmax(const char* data, size_t data_len,
                         const int64_t* offsets, int64_t n, int64_t* out) {
  if (n <= 0) return -1;
  if (offsets[0] < 0 || offsets[1] < offsets[0] ||
      static_cast<size_t>(offsets[1]) > data_len)
    return -1;  // row 0 is the running min/max base: validate it up front
  int64_t mn = 0, mx = 0;
  for (int64_t i = 1; i < n; i++) {
    int64_t io = offsets[i], il = offsets[i + 1] - io;
    if (io < 0 || il < 0 || static_cast<size_t>(io + il) > data_len) return -1;
    {
      int64_t mo = offsets[mn], ml = offsets[mn + 1] - mo;
      int64_t c = std::memcmp(data + io, data + mo, il < ml ? il : ml);
      if (c < 0 || (c == 0 && il < ml)) mn = i;
    }
    {
      int64_t mo = offsets[mx], ml = offsets[mx + 1] - mo;
      int64_t c = std::memcmp(data + io, data + mo, il < ml ? il : ml);
      if (c > 0 || (c == 0 && il > ml)) mx = i;
    }
  }
  out[0] = mn;
  out[1] = mx;
  return 0;
}

// Dictionary probe over numeric bit patterns (NaN payloads dedup by bits).
// elem_size selects uint32/uint64 elements so 32-bit columns probe their
// buffer in place. Same contract as ptq_bytes_dict_indices: fills indices[n]
// and firsts[<=max_uniques+1]; returns unique count, -2 over the cutoff
// (early exit — no O(n log n) sort for high-cardinality columns), -1 error.
ssize_t ptq_u64_dict_indices(const void* v_raw, int elem_size, int64_t n,
                             int64_t max_uniques, uint32_t* indices,
                             uint32_t* firsts) {
  if (n < 0 || max_uniques < 0) return -1;
  if (elem_size != 4 && elem_size != 8) return -1;
  if (n == 0) return 0;
  const uint32_t* v32 =
      elem_size == 4 ? static_cast<const uint32_t*>(v_raw) : nullptr;
  const uint64_t* v = elem_size == 8 ? static_cast<const uint64_t*>(v_raw) : nullptr;
  auto at = [&](int64_t i) -> uint64_t {
    return v ? v[i] : static_cast<uint64_t>(v32[i]);
  };
  size_t want = static_cast<size_t>(
      (max_uniques + 2) < n ? (max_uniques + 2) : n);
  size_t tsize = 64;
  while (tsize < want * 2) tsize <<= 1;
  uint32_t* table = static_cast<uint32_t*>(malloc(tsize * sizeof(uint32_t)));
  if (!table) return -1;
  std::memset(table, 0xff, tsize * sizeof(uint32_t));
  const size_t tmask = tsize - 1;
  int64_t uniques = 0;
  for (int64_t i = 0; i < n; i++) {
    uint64_t x = at(i);
    uint64_t h = x * 0x9e3779b97f4a7c15ull;
    h ^= h >> 29;
    size_t slot = static_cast<size_t>(h) & tmask;
    for (;;) {
      uint32_t uid = table[slot];
      if (uid == 0xffffffffu) {
        if (uniques >= max_uniques) {  // would exceed the cutoff: no dict
          free(table);
          return -2;
        }
        table[slot] = static_cast<uint32_t>(uniques);
        firsts[uniques] = static_cast<uint32_t>(i);
        indices[i] = static_cast<uint32_t>(uniques);
        uniques++;
        break;
      }
      if (at(firsts[uid]) == x) {
        indices[i] = uid;
        break;
      }
      slot = (slot + 1) & tmask;
    }
  }
  free(table);
  return static_cast<ssize_t>(uniques);
}

}  // extern "C"
