// Host-side prepare walk of parquet_tpu_torch: the whole-chunk page walk that
// feeds the CUDA decode kernels, and the block codecs it needs.
//
// A cut-down copy of the JAX package's native/parquet_tpu_native.cc (the
// port carries its own copy and never loads that library): snappy and LZ4
// (raw and hadoop-framed) block codecs, the hybrid and delta prescans, the
// compact-Thrift page-header parser, gzip inflate, level decode, the
// whole-chunk walk ptq_chunk_prepare, and the DELTA_BINARY_PACKED encoder the
// PLAIN->delta transfer repack uses. The host value functions (byte-array
// gather, take and encode, hybrid and delta decode, hybrid encode, XXH64,
// the statistics and dictionary probes) are in values.cc, linked into the
// same library; the bit reader/writer and varints both use are in bits.h.
// The encode walk and the bloom batch hashes are left out. The ABI
// (prepare.h) and the PTQ_E_* / PTQ_STAGE_* codes are identical to the
// original, so the two walks' tables compare field by field.
//
// Built at first use with g++ -O3 -fPIC -std=c++17 -shared ... -lz by
// parquet_tpu_torch/kernels/host_build.py and loaded with ctypes
// (parquet_tpu_torch/utils/native.py). All functions validate sizes before
// writing and return a negative code on corrupt input.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cstddef>
#include <ctime>        // per-stage prepare clocks (chunk_prepare stage_ns)
#include <sys/types.h>  // ssize_t
#include <zlib.h>       // gzip pages in the whole-chunk prepare walk

#include "bits.h"     // bit reader/writer and varints (shared with values.cc)
#include "prepare.h"  // shared ptq_chunk_prepare prototype

extern "C" {


// ---------------------------------------------------------------------------
// snappy block format
// ---------------------------------------------------------------------------

size_t ptq_snappy_max_compressed_length(size_t n) {
  // Worst case: all literals (header <= 5 bytes per element, one element) plus
  // copies that are only emitted when profitable (see emit rules), + varint.
  return 32 + n + n / 6;
}

// Tag-dispatch table for the fast decode loop: one lookup replaces the
// per-kind branch ladder. entry = (extra_trailer_bytes << 11) |
// (offset_high_bits << 8) | base_copy_length. Literal tags (kind 0) are
// dispatched before the table is consulted.
static uint16_t g_snappy_tag[256];
static const bool g_snappy_tag_init = [] {
  for (int c = 0; c < 256; c++) {
    uint16_t e = 0;
    switch (c & 3) {
      case 1:  // copy, 1-byte offset trailer, 3 offset bits in the tag
        e = static_cast<uint16_t>((1u << 11) | ((static_cast<uint32_t>(c) >> 5) << 8) |
                                  (((static_cast<uint32_t>(c) >> 2) & 7) + 4));
        break;
      case 2:  // copy, 2-byte little-endian offset
        e = static_cast<uint16_t>((2u << 11) | ((static_cast<uint32_t>(c) >> 2) + 1));
        break;
      case 3:  // copy, 4-byte little-endian offset
        e = static_cast<uint16_t>((4u << 11) | ((static_cast<uint32_t>(c) >> 2) + 1));
        break;
    }
    g_snappy_tag[c] = e;
  }
  return true;
}();
static const uint32_t g_snappy_wordmask[5] = {0, 0xffu, 0xffffu, 0xffffffu,
                                              0xffffffffu};

// Overshooting match copy: writes in 8/16-byte blocks, spilling at most 15
// bytes past out+length into the caller-guaranteed slack. Correct for every
// offset >= 1 (short periods are strided by the first period multiple >= 8).
static inline void snappy_copy_fast(char* op, const char* from, uint32_t length,
                                    uint32_t offset) {
  if (offset >= 8 && length <= 8) {
    std::memcpy(op, from, 8);
  } else if (offset >= 8 && length <= 16) {
    // the dominant op on structured numeric data (e.g. a 7-byte match at
    // offset 8 per int64): two fixed 8-byte moves, no loop, no call.
    // Reading from+8 may touch bytes the first move just wrote — for
    // offset 8..15 those bytes repeat the pattern, which is exactly what
    // the match semantics require.
    std::memcpy(op, from, 8);
    std::memcpy(op + 8, from + 8, 8);
  } else if (offset >= 16) {
    for (uint32_t i = 0; i < length; i += 16) std::memcpy(op + i, from + i, 16);
  } else if (offset >= 8) {
    for (uint32_t i = 0; i < length; i += 8) std::memcpy(op + i, from + i, 8);
  } else {
    // short period: byte-copy one full period multiple >= 8 (<= 14 bytes),
    // then stride by that multiple — still the same pattern, but each
    // 8-byte block is non-overlapping
    uint32_t off2 = offset;
    while (off2 < 8) off2 += offset;
    uint32_t head = off2 < length ? off2 : length;
    for (uint32_t i = 0; i < head; i++) op[i] = from[i];
    for (uint32_t i = head; i < length; i += 8) std::memcpy(op + i, op + i - off2, 8);
  }
}

ssize_t ptq_snappy_decompress(const char* src_c, size_t src_len,
                              char* dst, size_t dst_cap) {
  const uint8_t* src = reinterpret_cast<const uint8_t*>(src_c);
  size_t pos = 0;
  uint64_t expect = 0;
  int shift = 0;
  // preamble: uncompressed length varint
  for (;;) {
    if (pos >= src_len || shift > 63) return -1;
    uint8_t b = src[pos++];
    expect |= static_cast<uint64_t>(b & 0x7f) << shift;
    if (!(b & 0x80)) break;
    shift += 7;
  }
  if (expect > dst_cap) return -1;
  // Fast mode: a destination with >= 64 bytes of physical slack past `expect`
  // (chunk_prepare's scratch/values buffers are allocated that way) lets
  // copies run in overshooting 8/16-byte blocks and lets the tag trailer be
  // read as one unconditional 4-byte load — the decode stays LOGICALLY
  // bounded by `expect`, only the access granularity spills into the slack.
  // Exactly-sized destinations (the public codec entry point) take the
  // byte-exact careful loop below.
  const bool fast = dst_cap >= expect + 64;
  size_t out = 0;
  while (pos < src_len) {
    uint8_t tag = src[pos++];
    uint32_t kind = tag & 3;
    if (kind == 0) {  // literal
      uint32_t len = tag >> 2;
      if (len >= 60) {
        uint32_t extra = len - 59;  // 1..4 length bytes
        if (pos + extra > src_len) return -1;
        len = 0;
        for (uint32_t i = 0; i < extra; i++) len |= static_cast<uint32_t>(src[pos + i]) << (8 * i);
        pos += extra;
      }
      uint64_t n = static_cast<uint64_t>(len) + 1;
      if (pos + n > src_len || out + n > expect) return -1;
      if (fast && n <= 8 && pos + 8 <= src_len) {
        std::memcpy(dst + out, src + pos, 8);
      } else {
        std::memcpy(dst + out, src + pos, n);
      }
      out += n;
      pos += n;
    } else {
      uint32_t length, offset;
      if (fast && pos + 4 <= src_len) {
        // tag-dispatch: one table lookup + one unconditional 4-byte load
        // replaces the per-kind branch ladder (trailer bytes beyond the
        // tag's count are masked off, never consumed)
        const uint16_t e = g_snappy_tag[tag];
        const uint32_t extra = e >> 11;
        uint32_t data;
        std::memcpy(&data, src + pos, 4);
        offset = (e & 0x700u) + (data & g_snappy_wordmask[extra]);
        length = e & 0xffu;
        pos += extra;
      } else if (kind == 1) {
        if (pos + 1 > src_len) return -1;
        length = ((tag >> 2) & 7) + 4;
        offset = (static_cast<uint32_t>(tag >> 5) << 8) | src[pos];
        pos += 1;
      } else if (kind == 2) {
        if (pos + 2 > src_len) return -1;
        length = (tag >> 2) + 1;
        offset = static_cast<uint32_t>(src[pos]) | (static_cast<uint32_t>(src[pos + 1]) << 8);
        pos += 2;
      } else {
        if (pos + 4 > src_len) return -1;
        length = (tag >> 2) + 1;
        offset = static_cast<uint32_t>(src[pos]) | (static_cast<uint32_t>(src[pos + 1]) << 8) |
                 (static_cast<uint32_t>(src[pos + 2]) << 16) | (static_cast<uint32_t>(src[pos + 3]) << 24);
        pos += 4;
      }
      if (offset == 0 || offset > out || out + length > expect) return -1;
      const char* from = dst + out - offset;
      char* op = dst + out;
      if (fast) {
        snappy_copy_fast(op, from, length, offset);
      } else if (offset >= 8) {
        // Non-overlapping at 8-byte granularity for the body (~2x on
        // match-heavy pages vs the byte loop); the sub-8 tail is copied
        // byte-wise so no write ever lands past `expect` — an exactly-sized
        // destination buffer is safe, no out-of-band spare-capacity contract.
        uint32_t wide = length & ~7u;
        for (uint32_t i = 0; i < wide; i += 8) std::memcpy(op + i, from + i, 8);
        for (uint32_t i = wide; i < length; i++) op[i] = from[i];
      } else {
        // overlapping copy must run forward byte-by-byte (RLE-style matches)
        for (uint32_t i = 0; i < length; i++) op[i] = from[i];
      }
      out += length;
    }
  }
  return out == expect ? static_cast<ssize_t>(out) : -1;
}

static inline uint32_t snappy_hash(uint32_t v) {
  return (v * 0x1e35a7bdu) >> 18;  // 14-bit table
}

// Emits one literal element (callers never pass len >= 2^32). Returns false on
// insufficient space in dst.
static bool emit_literal(const uint8_t* src, size_t from, size_t len,
                         char* dst, size_t dst_cap, size_t* out) {
  if (len == 0) return true;
  if (*out + 5 + len > dst_cap) return false;
  size_t n = len - 1;
  if (n < 60) {
    dst[(*out)++] = static_cast<char>(n << 2);
  } else if (n < (1u << 8)) {
    dst[(*out)++] = static_cast<char>(60 << 2);
    dst[(*out)++] = static_cast<char>(n);
  } else if (n < (1u << 16)) {
    dst[(*out)++] = static_cast<char>(61 << 2);
    dst[(*out)++] = static_cast<char>(n);
    dst[(*out)++] = static_cast<char>(n >> 8);
  } else if (n < (1u << 24)) {
    dst[(*out)++] = static_cast<char>(62 << 2);
    dst[(*out)++] = static_cast<char>(n);
    dst[(*out)++] = static_cast<char>(n >> 8);
    dst[(*out)++] = static_cast<char>(n >> 16);
  } else {
    dst[(*out)++] = static_cast<char>(63 << 2);
    dst[(*out)++] = static_cast<char>(n);
    dst[(*out)++] = static_cast<char>(n >> 8);
    dst[(*out)++] = static_cast<char>(n >> 16);
    dst[(*out)++] = static_cast<char>(n >> 24);
  }
  std::memcpy(dst + *out, src + from, len);
  *out += len;
  return true;
}

static bool emit_copy(size_t offset, size_t len, char* dst, size_t dst_cap,
                      size_t* out) {
  while (len > 0) {
    size_t chunk = len > 64 ? 64 : len;
    // keep the final chunk >= 4 (canonical decoders may reject shorter copies)
    if (chunk == 64 && len - chunk > 0 && len - chunk < 4) chunk = 60;
    if (*out + 5 > dst_cap) return false;
    if (chunk >= 4 && chunk <= 11 && offset < 2048) {
      dst[(*out)++] = static_cast<char>(((offset >> 8) << 5) | ((chunk - 4) << 2) | 1);
      dst[(*out)++] = static_cast<char>(offset & 0xff);
    } else if (offset < (1u << 16)) {
      dst[(*out)++] = static_cast<char>(((chunk - 1) << 2) | 2);
      dst[(*out)++] = static_cast<char>(offset & 0xff);
      dst[(*out)++] = static_cast<char>(offset >> 8);
    } else {
      dst[(*out)++] = static_cast<char>(((chunk - 1) << 2) | 3);
      dst[(*out)++] = static_cast<char>(offset & 0xff);
      dst[(*out)++] = static_cast<char>((offset >> 8) & 0xff);
      dst[(*out)++] = static_cast<char>((offset >> 16) & 0xff);
      dst[(*out)++] = static_cast<char>((offset >> 24) & 0xff);
    }
    len -= chunk;
  }
  return true;
}

ssize_t ptq_snappy_compress(const char* src_c, size_t src_len,
                            char* dst, size_t dst_cap) {
  if (dst_cap < ptq_snappy_max_compressed_length(src_len)) return -1;
  const uint8_t* src = reinterpret_cast<const uint8_t*>(src_c);
  size_t out = 0;
  // preamble
  {
    uint64_t v = src_len;
    while (v >= 0x80) { dst[out++] = static_cast<char>(v | 0x80); v >>= 7; }
    dst[out++] = static_cast<char>(v);
  }
  if (src_len == 0) return static_cast<ssize_t>(out);
  constexpr size_t kTableSize = 1 << 14;
  static thread_local uint32_t table[kTableSize];
  std::memset(table, 0, sizeof(table));
  size_t lit_start = 0;
  size_t pos = 0;
  if (src_len >= 8) {
    const size_t limit = src_len - 4;
    // google-snappy's miss-acceleration: after 32 consecutive misses the
    // scan starts stepping 2, then 3, ... bytes at a time — incompressible
    // input (bit-packed dictionary indices, already-compressed blobs) costs
    // ~O(n/step) hash probes instead of one per byte. A found match resets
    // the window. (Output stays valid snappy; the ratio on borderline data
    // trades a hair for a large incompressible-page speedup.)
    uint32_t skip = 32;
    while (pos < limit) {
      uint32_t cur;
      std::memcpy(&cur, src + pos, 4);
      uint32_t h = snappy_hash(cur);
      size_t cand = table[h];
      table[h] = static_cast<uint32_t>(pos);
      uint32_t cv;
      if (cand < pos && pos - cand < (1ull << 32) &&
          (std::memcpy(&cv, src + cand, 4), cv == cur)) {
        // extend match
        size_t len = 4;
        while (pos + len < src_len && src[cand + len] == src[pos + len]) len++;
        size_t offset = pos - cand;
        // Profitability: a far copy costs 5 bytes; only take it when it beats
        // the literal it replaces, which also keeps the advertised
        // max_compressed_length bound valid (no expanding elements).
        if (offset >= (1u << 16) && len < 8) {
          pos++;
          continue;
        }
        if (pos > lit_start &&
            !emit_literal(src, lit_start, pos - lit_start, dst, dst_cap, &out))
          return -1;
        if (!emit_copy(offset, len, dst, dst_cap, &out)) return -1;
        pos += len;
        lit_start = pos;
        skip = 32;
      } else {
        pos += skip++ >> 5;
      }
    }
  }
  if (lit_start < src_len &&
      !emit_literal(src, lit_start, src_len - lit_start, dst, dst_cap, &out))
    return -1;
  return static_cast<ssize_t>(out);
}

// ---------------------------------------------------------------------------
// LZ4 block format (+ the Hadoop framing parquet's legacy LZ4 codec uses)
//
// Implemented from the public LZ4 block format description: sequences of
// [token: literal-length nibble | match-length nibble][literals]
// [2-byte LE match offset][length extension bytes], final sequence literals
// only. Strict bounds validation before every write; -1 on corrupt input.
// ---------------------------------------------------------------------------

size_t ptq_lz4_max_compressed_length(size_t n) {
  // worst case: one literal run (1 token + ceil(n/255) extensions + n bytes)
  return 16 + n + n / 255;
}

ssize_t ptq_lz4_decompress(const char* src_c, size_t src_len,
                           char* dst, size_t expect) {
  const uint8_t* src = reinterpret_cast<const uint8_t*>(src_c);
  size_t pos = 0;
  size_t out = 0;
  if (src_len == 0) return expect == 0 ? 0 : -1;
  while (pos < src_len) {
    uint8_t token = src[pos++];
    // literals
    uint64_t lit = token >> 4;
    if (lit == 15) {
      for (;;) {
        if (pos >= src_len) return -1;
        uint8_t b = src[pos++];
        lit += b;
        if (b != 255) break;
        if (lit > (1ull << 40)) return -1;  // length bomb
      }
    }
    if (pos + lit > src_len || out + lit > expect) return -1;
    std::memcpy(dst + out, src + pos, lit);
    out += lit;
    pos += lit;
    if (pos == src_len) break;  // last sequence carries literals only
    // match
    if (pos + 2 > src_len) return -1;
    uint32_t offset = static_cast<uint32_t>(src[pos]) |
                      (static_cast<uint32_t>(src[pos + 1]) << 8);
    pos += 2;
    if (offset == 0 || offset > out) return -1;
    uint64_t mlen = token & 15;
    if (mlen == 15) {
      for (;;) {
        if (pos >= src_len) return -1;
        uint8_t b = src[pos++];
        mlen += b;
        if (b != 255) break;
        if (mlen > (1ull << 40)) return -1;
      }
    }
    mlen += 4;  // minmatch
    if (out + mlen > expect) return -1;
    const char* from = dst + out - offset;
    char* op = dst + out;
    if (offset >= 8) {
      // non-overlapping at 8-byte granularity; sub-8 tail byte-wise so no
      // write lands past `expect` (same contract as the snappy decoder)
      uint64_t wide = mlen & ~7ull;
      for (uint64_t i = 0; i < wide; i += 8) std::memcpy(op + i, from + i, 8);
      for (uint64_t i = wide; i < mlen; i++) op[i] = from[i];
    } else {
      for (uint64_t i = 0; i < mlen; i++) op[i] = from[i];  // RLE overlap
    }
    out += mlen;
  }
  return out == expect ? static_cast<ssize_t>(out) : -1;
}

static inline uint32_t lz4_hash(uint32_t v) {
  return (v * 2654435761u) >> 19;  // 13-bit table
}

// Append a literal/match length in LZ4's nibble + 255-extension form.
static inline bool lz4_put_len(uint64_t extra, char* dst, size_t dst_cap,
                               size_t* out) {
  while (extra >= 255) {
    if (*out >= dst_cap) return false;
    dst[(*out)++] = static_cast<char>(255);
    extra -= 255;
  }
  if (*out >= dst_cap) return false;
  dst[(*out)++] = static_cast<char>(extra);
  return true;
}

ssize_t ptq_lz4_compress(const char* src_c, size_t src_len,
                         char* dst, size_t dst_cap) {
  if (dst_cap < ptq_lz4_max_compressed_length(src_len)) return -1;
  const uint8_t* src = reinterpret_cast<const uint8_t*>(src_c);
  size_t out = 0;
  size_t lit_start = 0;
  size_t pos = 0;
  constexpr size_t kTableSize = 1 << 13;
  static thread_local uint32_t table[kTableSize];
  // The format forbids matches in the final 12 bytes (spec end-of-block
  // rule: last sequence is literals-only and >= 5 bytes, matches must not
  // start within the last 12) — canonical decoders rely on it.
  if (src_len > 12) {
    std::memset(table, 0, sizeof(table));
    const size_t match_limit = src_len - 12;
    while (pos <= match_limit) {
      uint32_t cur;
      std::memcpy(&cur, src + pos, 4);
      uint32_t h = lz4_hash(cur);
      size_t cand = table[h];
      table[h] = static_cast<uint32_t>(pos);
      uint32_t cv;
      if (cand < pos && pos - cand < (1u << 16) &&
          (std::memcpy(&cv, src + cand, 4), cv == cur)) {
        // extend, but never into the last 5 bytes (they must stay literal)
        size_t max_len = src_len - 5 - pos;
        size_t len = 4;
        while (len < max_len && src[cand + len] == src[pos + len]) len++;
        size_t lit = pos - lit_start;
        uint8_t tok_lit = lit >= 15 ? 15 : static_cast<uint8_t>(lit);
        uint8_t tok_m = (len - 4) >= 15 ? 15 : static_cast<uint8_t>(len - 4);
        if (out >= dst_cap) return -1;
        dst[out++] = static_cast<char>((tok_lit << 4) | tok_m);
        if (tok_lit == 15 && !lz4_put_len(lit - 15, dst, dst_cap, &out))
          return -1;
        if (out + lit > dst_cap) return -1;
        std::memcpy(dst + out, src + lit_start, lit);
        out += lit;
        size_t offset = pos - cand;
        if (out + 2 > dst_cap) return -1;
        dst[out++] = static_cast<char>(offset & 0xff);
        dst[out++] = static_cast<char>(offset >> 8);
        if (tok_m == 15 && !lz4_put_len(len - 4 - 15, dst, dst_cap, &out))
          return -1;
        pos += len;
        lit_start = pos;
      } else {
        pos++;
      }
    }
  }
  // trailing literals (the whole input when src_len <= 12)
  {
    size_t lit = src_len - lit_start;
    uint8_t tok_lit = lit >= 15 ? 15 : static_cast<uint8_t>(lit);
    if (out >= dst_cap) return -1;
    dst[out++] = static_cast<char>(tok_lit << 4);
    if (tok_lit == 15 && !lz4_put_len(lit - 15, dst, dst_cap, &out)) return -1;
    if (out + lit > dst_cap) return -1;
    std::memcpy(dst + out, src + lit_start, lit);
    out += lit;
  }
  return static_cast<ssize_t>(out);
}

// Parquet's legacy LZ4 codec (id 5) is Hadoop-framed on disk: repeated
// [4B BE uncompressed size][4B BE compressed size][raw block]; some writers
// emit bare raw blocks instead. Mirror parquet-cpp: try the framing, fall
// back to one raw block.
ssize_t ptq_lz4_hadoop_decompress(const char* src_c, size_t src_len,
                                  char* dst, size_t expect) {
  const uint8_t* src = reinterpret_cast<const uint8_t*>(src_c);
  size_t pos = 0;
  size_t out = 0;
  bool framed = true;
  while (pos < src_len) {
    if (pos + 8 > src_len) { framed = false; break; }
    uint64_t usz = (static_cast<uint32_t>(src[pos]) << 24) |
                   (static_cast<uint32_t>(src[pos + 1]) << 16) |
                   (static_cast<uint32_t>(src[pos + 2]) << 8) |
                   static_cast<uint32_t>(src[pos + 3]);
    uint64_t csz = (static_cast<uint32_t>(src[pos + 4]) << 24) |
                   (static_cast<uint32_t>(src[pos + 5]) << 16) |
                   (static_cast<uint32_t>(src[pos + 6]) << 8) |
                   static_cast<uint32_t>(src[pos + 7]);
    if (pos + 8 + csz > src_len || out + usz > expect) { framed = false; break; }
    ssize_t got = ptq_lz4_decompress(src_c + pos + 8, csz, dst + out, usz);
    if (got < 0 || static_cast<uint64_t>(got) != usz) { framed = false; break; }
    out += usz;
    pos += 8 + csz;
  }
  if (framed && out == expect) return static_cast<ssize_t>(out);
  return ptq_lz4_decompress(src_c, src_len, dst, expect);
}


// ---------------------------------------------------------------------------
// hybrid RLE/bit-pack run-header prescan
// ---------------------------------------------------------------------------

// Outputs one row per run. bp_offsets are ABSOLUTE byte offsets into src
// (the caller uses src itself as the packed buffer). Returns the number of
// runs, or -1 on corrupt input, or -2 if max_runs is too small.
ssize_t ptq_prescan_hybrid(const uint8_t* src, size_t src_len, int64_t num_values,
                           int width, uint8_t* is_rle, int64_t* counts,
                           uint64_t* values, int64_t* bp_offsets,
                           size_t max_runs, int64_t* consumed) {
  if (width < 0 || width > 64) return -1;
  const size_t vbytes = (width + 7) / 8;
  size_t pos = 0;
  int64_t produced = 0;
  size_t runs = 0;
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
    if (runs >= max_runs) return -2;
    if (header & 1) {
      uint64_t groups = header >> 1;
      // overflow guards before any multiply (the Python fallback rejects these
      // via arbitrary-precision arithmetic; keep parity)
      if (groups == 0 || groups > (1ull << 40)) return -1;
      uint64_t count = groups * 8;
      uint64_t nbytes = groups * static_cast<uint64_t>(width);
      if (pos + nbytes > src_len) return -1;
      is_rle[runs] = 0;
      counts[runs] = static_cast<int64_t>(count);
      values[runs] = 0;
      bp_offsets[runs] = static_cast<int64_t>(pos);
      pos += nbytes;
      produced += static_cast<int64_t>(count);
    } else {
      uint64_t count = header >> 1;
      if (count == 0 || count > (1ull << 40) || pos + vbytes > src_len) return -1;
      uint64_t v = 0;
      for (size_t i = 0; i < vbytes; i++) v |= static_cast<uint64_t>(src[pos + i]) << (8 * i);
      if (width < 64 && v >= (1ull << width)) return -1;
      pos += vbytes;
      is_rle[runs] = 1;
      counts[runs] = static_cast<int64_t>(count);
      values[runs] = v;
      bp_offsets[runs] = 0;
      produced += static_cast<int64_t>(count);
    }
    runs++;
  }
  *consumed = static_cast<int64_t>(pos);
  return static_cast<ssize_t>(runs);
}

// ---------------------------------------------------------------------------
// DELTA_BINARY_PACKED header-only prescan (device-decode planning hot path)
// ---------------------------------------------------------------------------

// Walks block/miniblock headers only (payload bytes stay packed for the
// device kernel). One table entry per miniblock covering >=1 real delta.
// Semantics mirror ops/delta.py prescan_delta_packed exactly. Returns the
// number of entries M, or -1 corrupt, -2 table overflow, -3 count exceeds
// max_total / implausible.
ssize_t ptq_prescan_delta_packed(const uint8_t* src, size_t src_len, int nbits,
                                 int64_t max_total, uint32_t* widths,
                                 int64_t* byte_starts, int32_t* out_starts,
                                 uint64_t* mins, size_t max_entries,
                                 uint64_t* first_value, int64_t* total_out,
                                 int64_t* consumed) {
  if (nbits != 32 && nbits != 64) return -1;
  size_t pos = 0;
  uint64_t block_size, mini_count, total_u, first_zz;
  if (!read_uvarint64(src, src_len, &pos, &block_size)) return -1;
  if (!read_uvarint64(src, src_len, &pos, &mini_count)) return -1;
  if (!read_uvarint64(src, src_len, &pos, &total_u)) return -1;
  if (!read_uvarint64(src, src_len, &pos, &first_zz)) return -1;
  if (block_size == 0 || block_size % 128 != 0 || block_size > (1ull << 20)) return -1;
  if (mini_count == 0 || mini_count > 512 || block_size % mini_count != 0) return -1;
  uint64_t mini_len = block_size / mini_count;
  if (mini_len % 8 != 0) return -1;
  if (total_u > (1ull << 62)) return -1;
  int64_t total = static_cast<int64_t>(total_u);
  if (max_total < 0) max_total = 0;  // match Python's max(max_total, 0) clamp
  if (total > max_total) return -3;
  uint64_t plausible = 1 + (src_len / (1 + mini_count) + 1) * block_size;
  if (total_u > plausible) return -3;
  const uint64_t mask = (nbits == 64) ? ~0ull : ((1ull << nbits) - 1);
  *first_value = ((first_zz >> 1) ^ (~(first_zz & 1) + 1)) & mask;
  *total_out = total;

  int64_t n_deltas = total > 1 ? total - 1 : 0;
  int64_t produced = 0;
  size_t m = 0;
  while (produced < n_deltas) {
    uint64_t md_zz;
    if (!read_uvarint64(src, src_len, &pos, &md_zz)) return -1;
    uint64_t min_delta = ((md_zz >> 1) ^ (~(md_zz & 1) + 1)) & mask;
    if (pos + mini_count > src_len) return -1;
    const uint8_t* wb = src + pos;
    pos += mini_count;
    for (uint64_t i = 0; i < mini_count; i++) {
      int64_t remaining = n_deltas - produced;
      if (remaining <= 0) continue;  // unused trailing miniblock: no payload
      int w = wb[i];
      if (w > nbits) return -1;
      uint64_t payload = (mini_len / 8) * static_cast<uint64_t>(w);
      if (pos + payload > src_len) return -1;
      if (m >= max_entries) return -2;
      widths[m] = static_cast<uint32_t>(w);
      byte_starts[m] = static_cast<int64_t>(pos);
      out_starts[m] = static_cast<int32_t>(produced);
      mins[m] = min_delta;
      m++;
      pos += payload;
      produced += remaining < static_cast<int64_t>(mini_len)
                      ? remaining : static_cast<int64_t>(mini_len);
    }
  }
  *consumed = static_cast<int64_t>(pos);
  return static_cast<ssize_t>(m);
}

// ---------------------------------------------------------------------------
// Thrift compact-protocol PageHeader parser (one header per page — the hot
// metadata path, SURVEY §7.3.6). Unknown/unneeded fields (statistics) are
// skipped by wire type exactly like generated Thrift readers.
// ---------------------------------------------------------------------------

namespace {

struct CpReader {
  const uint8_t* src;
  size_t len;
  size_t pos;
  bool truncated;  // ran off the window (retry with a larger peek)
};

inline bool cp_byte(CpReader* r, uint8_t* out) {
  if (r->pos >= r->len) { r->truncated = true; return false; }
  *out = r->src[r->pos++];
  return true;
}

inline bool cp_uvarint(CpReader* r, uint64_t* out) {
  uint64_t v = 0;
  int shift = 0;
  for (;;) {
    uint8_t b;
    if (!cp_byte(r, &b)) return false;
    if (shift > 63) return false;
    v |= static_cast<uint64_t>(b & 0x7f) << shift;
    if (!(b & 0x80)) break;
    shift += 7;
  }
  *out = v;
  return true;
}

inline bool cp_zigzag(CpReader* r, int64_t* out) {
  uint64_t u;
  if (!cp_uvarint(r, &u)) return false;
  *out = static_cast<int64_t>((u >> 1) ^ (~(u & 1) + 1));
  return true;
}

bool cp_skip(CpReader* r, int wire, int depth);

// Skip the fields of a struct up to and including STOP.
bool cp_skip_struct(CpReader* r, int depth) {
  if (depth > 16) return false;
  for (;;) {
    uint8_t fh;
    if (!cp_byte(r, &fh)) return false;
    if (fh == 0) return true;  // STOP
    if (!(fh >> 4)) {          // long form: explicit zigzag field id
      int64_t fid;
      if (!cp_zigzag(r, &fid)) return false;
    }
    if (!cp_skip(r, fh & 0x0F, depth)) return false;
  }
}

bool cp_skip(CpReader* r, int wire, int depth) {
  if (depth > 16) return false;
  uint64_t u;
  int64_t s;
  uint8_t b;
  switch (wire) {
    case 1: case 2: return true;        // bool true/false: value in type nibble
    case 3: return cp_byte(r, &b);      // byte
    case 4: case 5: case 6:             // i16/i32/i64: zigzag varint
      return cp_zigzag(r, &s);
    case 7:                             // double: 8 bytes
      if (r->pos + 8 > r->len) { r->truncated = true; return false; }
      r->pos += 8;
      return true;
    case 8:                             // binary: len + bytes
      if (!cp_uvarint(r, &u)) return false;
      // Subtraction form: pos <= len is invariant, so len-pos cannot
      // underflow, and a near-2^64 u cannot wrap the addition-form check.
      if (u > r->len - r->pos) { r->truncated = true; return false; }
      r->pos += u;
      return true;
    case 9: case 10: {                  // list/set: (size<<4)|etype
      if (!cp_byte(r, &b)) return false;
      uint64_t n = b >> 4;
      int etype = b & 0x0F;
      if (n == 15 && !cp_uvarint(r, &n)) return false;
      // Preflight size guard: every element occupies >= 1 wire byte, EXCEPT
      // bool (kind 1/2), whose cp_skip consumes nothing — a lying count
      // there would spin this loop for up to 2^64 iterations (a hang, not
      // an overread). pos <= len is invariant, so len-pos cannot underflow.
      if (n > r->len - r->pos) { r->truncated = true; return false; }
      if (etype == 1 || etype == 2) {   // bool list: 1 byte per element
        r->pos += n;
        return true;
      }
      for (uint64_t i = 0; i < n; i++)
        if (!cp_skip(r, etype, depth + 1)) return false;
      return true;
    }
    case 11: {                          // map: size==0 -> empty, else kv types
      if (!cp_uvarint(r, &u)) return false;
      if (u == 0) return true;
      if (!cp_byte(r, &b)) return false;
      // Same hang guard as list/set: a bool key/value type would make each
      // iteration consume zero bytes, so an adversarial count must be
      // rejected against the remaining window up front.
      if (u > r->len - r->pos) { r->truncated = true; return false; }
      int kt = b >> 4, vt = b & 0x0F;
      for (uint64_t i = 0; i < u; i++) {
        // map bool keys/values occupy one byte each on the wire (unlike
        // bool STRUCT fields, whose value rides the field header)
        if (kt == 1 || kt == 2) {
          if (r->pos >= r->len) { r->truncated = true; return false; }
          r->pos++;
        } else if (!cp_skip(r, kt, depth + 1)) {
          return false;
        }
        if (vt == 1 || vt == 2) {
          if (r->pos >= r->len) { r->truncated = true; return false; }
          r->pos++;
        } else if (!cp_skip(r, vt, depth + 1)) {
          return false;
        }
      }
      return true;
    }
    case 12: return cp_skip_struct(r, depth + 1);
    default: return false;              // unknown wire type: corrupt
  }
}

// Parse one nested header struct, keeping declared fields into keep[fid-1].
// kinds[fid-1] gives the declared type: 'i' int (i16/i32/i64), 'b' bool.
// A field whose wire type mismatches its declaration is skipped by wire type
// (left absent), matching the Python reader's _wire_matches discipline.
bool cp_parse_flat_struct(CpReader* r, int64_t* keep, const char* kinds,
                          int n_keep) {
  int64_t fid = 0;
  for (;;) {
    uint8_t fh;
    if (!cp_byte(r, &fh)) return false;
    if (fh == 0) return true;
    int delta = fh >> 4;
    int wire = fh & 0x0F;
    if (delta) fid += delta;
    else if (!cp_zigzag(r, &fid)) return false;
    char kind = (fid >= 1 && fid <= n_keep) ? kinds[fid - 1] : 0;
    if (kind == 'b' && (wire == 1 || wire == 2)) {
      keep[fid - 1] = (wire == 1) ? 1 : 0;
    } else if (kind == 'i' && wire == 5) {  // exact CT_I32, like _wire_matches
      int64_t v;
      if (!cp_zigzag(r, &v)) return false;
      keep[fid - 1] = v;
    } else {
      if (!cp_skip(r, wire, 0)) return false;
    }
  }
}

}  // namespace

// Slot layout of out[28] (absent = INT64_MIN):
//   0 consumed bytes         1 type    2 uncompressed_size  3 compressed_size
//   4 crc
//   5 v1 present   6..9   v1 {num_values, encoding, def_enc, rep_enc}
//  10 dict present 11..13 dict {num_values, encoding, is_sorted}
//  14 v2 present   15..21 v2 {num_values, num_nulls, num_rows, encoding,
//                             def_len, rep_len, is_compressed}
//  22 index present
// Returns 0 on success, -1 corrupt, -2 window truncated (retry larger).
ssize_t ptq_parse_page_header(const uint8_t* src, size_t src_len, int64_t* out) {
  const int64_t ABSENT = INT64_MIN;
  for (int i = 0; i < 23; i++) out[i] = ABSENT;
  CpReader r{src, src_len, 0, false};
  int64_t fid = 0;
  for (;;) {
    uint8_t fh;
    if (!cp_byte(&r, &fh)) return r.truncated ? -2 : -1;
    if (fh == 0) break;  // STOP
    int delta = fh >> 4;
    int wire = fh & 0x0F;
    if (delta) fid += delta;
    else if (!cp_zigzag(&r, &fid)) return r.truncated ? -2 : -1;
    bool ok = true;
    if (fid >= 1 && fid <= 4 && wire == 5) {  // all i32 fields: exact CT_I32
      int64_t v;
      ok = cp_zigzag(&r, &v);
      if (ok) out[fid] = v;
    } else if (fid == 5 && wire == 12) {
      int64_t keep[4] = {ABSENT, ABSENT, ABSENT, ABSENT};
      ok = cp_parse_flat_struct(&r, keep, "iiii", 4);
      if (ok) { out[5] = 1; for (int i = 0; i < 4; i++) out[6 + i] = keep[i]; }
    } else if (fid == 6 && wire == 12) {
      ok = cp_skip_struct(&r, 1);
      if (ok) out[22] = 1;
    } else if (fid == 7 && wire == 12) {
      int64_t keep[3] = {ABSENT, ABSENT, ABSENT};
      ok = cp_parse_flat_struct(&r, keep, "iib", 3);
      if (ok) { out[10] = 1; for (int i = 0; i < 3; i++) out[11 + i] = keep[i]; }
    } else if (fid == 8 && wire == 12) {
      int64_t keep[7] = {ABSENT, ABSENT, ABSENT, ABSENT, ABSENT, ABSENT, ABSENT};
      ok = cp_parse_flat_struct(&r, keep, "iiiiiib", 7);
      if (ok) { out[14] = 1; for (int i = 0; i < 7; i++) out[15 + i] = keep[i]; }
    } else {
      ok = cp_skip(&r, wire, 0);
    }
    if (!ok) return r.truncated ? -2 : -1;
  }
  out[0] = static_cast<int64_t>(r.pos);
  return 0;
}

// ---------------------------------------------------------------------------
// Whole-chunk prepare walk (one native call per chunk).
//
// The per-page Python loop (header parse -> decompress -> level decode ->
// prescan -> route) is the dominant host cost of the device decode pipeline
// on wide files (reference page walk: chunk_reader.go:182-263). This fuses
// the entire walk: the caller hands the chunk's bytes plus output buffers
// and gets back packed per-page tables ready for vectorized batch assembly.
// Any input the walk cannot handle (unknown codec, corrupt stream, capacity
// overflow) returns a negative code and the caller falls back to the Python
// walk, which reproduces the exact error semantics.
// ---------------------------------------------------------------------------

namespace {

// gzip/zlib inflate with exact-size output (bomb guard: an output larger than
// `expect` fails instead of allocating; mirrors core/compress.py _Gzip).
bool gzip_inflate(const uint8_t* src, size_t src_len, uint8_t* dst, size_t expect) {
  z_stream s;
  std::memset(&s, 0, sizeof(s));
  if (inflateInit2(&s, 15 + 32) != Z_OK) return false;  // auto gzip/zlib header
  s.next_in = const_cast<Bytef*>(src);
  s.avail_in = static_cast<uInt>(src_len);
  s.next_out = dst;
  s.avail_out = static_cast<uInt>(expect);
  int rc = inflate(&s, Z_FINISH);
  bool ok = (rc == Z_STREAM_END && s.total_out == expect && s.avail_in == 0);
  inflateEnd(&s);
  return ok;
}

inline int level_bit_width(int max_level) {
  int w = 0;
  while (max_level) { w++; max_level >>= 1; }  // bit_length
  return w;
}

// Decompress one page block into scratch. Returns 0 ok, -1 corrupt/unknown
// codec, -5 scratch too small (same code contract as ptq_chunk_prepare).
int decompress_page(int codec, const uint8_t* src, size_t src_len,
                    uint8_t* scratch, size_t scratch_cap, size_t expect) {
  if (expect > scratch_cap) return -5;
  if (codec == 1) {
    // pass the PHYSICAL capacity: chunk_prepare allocates scratch with
    // >= 64 bytes of slack past the chunk's uncompressed size, which
    // switches the decoder into overshooting fast mode; the result is
    // still validated against the page's claimed size
    if (ptq_snappy_decompress(reinterpret_cast<const char*>(src), src_len,
                              reinterpret_cast<char*>(scratch), scratch_cap) !=
        static_cast<ssize_t>(expect))
      return -1;
    return 0;
  }
  if (codec == 2) return gzip_inflate(src, src_len, scratch, expect) ? 0 : -1;
  if (codec == 5)  // legacy LZ4: hadoop framing with raw-block fallback
    return ptq_lz4_hadoop_decompress(reinterpret_cast<const char*>(src),
                                     src_len, reinterpret_cast<char*>(scratch),
                                     expect) == static_cast<ssize_t>(expect)
               ? 0
               : -1;
  if (codec == 7)  // LZ4_RAW: one raw block
    return ptq_lz4_decompress(reinterpret_cast<const char*>(src), src_len,
                              reinterpret_cast<char*>(scratch), expect) ==
                   static_cast<ssize_t>(expect)
               ? 0
               : -1;
  return -1;
}

// Hybrid-decode a level stream into uint16, validating every value
// <= max_level (parity with ops/levels.py _check) and counting values equal
// to `target`. Returns bytes consumed, or -1 on corrupt input.
ssize_t decode_levels16(const uint8_t* src, size_t src_len, int64_t n,
                        int max_level, uint16_t* out, int target,
                        int64_t* eq_count) {
  const int width = level_bit_width(max_level);
  const size_t vbytes = (width + 7) / 8;
  size_t pos = 0;
  int64_t produced = 0;
  int64_t eq = 0;
  while (produced < n) {
    uint64_t header = 0;
    int shift = 0;
    for (;;) {
      if (pos >= src_len || shift > 63) return -1;
      uint8_t b = src[pos++];
      if (shift == 63 && (b & 0x7e)) return -1;
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
      int64_t take = n - produced;
      if (static_cast<uint64_t>(take) > count) take = static_cast<int64_t>(count);
      if (width <= 4 && (8 % width) == 0) {
        // levels are almost always width 1 or 2: unpack whole bytes instead
        // of feeding a bit reader one value at a time (the nested-column
        // hot loop — every leaf value decodes max_rep + max_def levels)
        const int per = 8 / width;
        const uint16_t mask = static_cast<uint16_t>((1u << width) - 1);
        const uint8_t* bp = src + pos;
        uint16_t* op = out + produced;
        int64_t full = take / per;
        uint64_t bad = 0;
        for (int64_t b = 0; b < full; b++) {
          uint16_t byte = bp[b];
          for (int j = 0; j < per; j++) {
            uint16_t v = (byte >> (j * width)) & mask;
            op[b * per + j] = v;
            bad |= (v > max_level);
            eq += (v == target);
          }
        }
        for (int64_t i = full * per; i < take; i++) {
          uint16_t v = (bp[i / per] >> ((i % per) * width)) & mask;
          op[i] = v;
          bad |= (v > max_level);
          eq += (v == target);
        }
        if (bad) return -1;
      } else {
        BitReader r;
        br_init(&r, src + pos, nbytes);
        for (int64_t i = 0; i < take; i++) {
          uint64_t v = br_read(&r, width);
          if (v > static_cast<uint64_t>(max_level)) return -1;
          out[produced + i] = static_cast<uint16_t>(v);
          eq += (static_cast<int>(v) == target);
        }
      }
      pos += nbytes;
      produced += take;
    } else {
      uint64_t count = header >> 1;
      if (count == 0 || count > (1ull << 40) || pos + vbytes > src_len) return -1;
      uint64_t v = 0;
      for (size_t i = 0; i < vbytes; i++) v |= static_cast<uint64_t>(src[pos + i]) << (8 * i);
      if (width < 64 && v >= (1ull << width)) return -1;
      if (v > static_cast<uint64_t>(max_level)) return -1;
      pos += vbytes;
      int64_t take = n - produced;
      if (static_cast<uint64_t>(take) > count) take = static_cast<int64_t>(count);
      uint16_t v16 = static_cast<uint16_t>(v);
      for (int64_t i = 0; i < take; i++) out[produced + i] = v16;
      if (static_cast<int>(v) == target) eq += take;
      produced += take;
    }
  }
  if (eq_count) *eq_count = eq;
  return static_cast<ssize_t>(pos);
}

// Per-stage wall clock for the whole-chunk walk. All accounting is skipped
// when the caller passes no stage array (ns == nullptr): production calls pay
// one branch per stage boundary, the bench pays ~25 ns per clock_gettime.
struct StageClock {
  int64_t* ns;
  int64_t t0;
  static inline int64_t now() {
    timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return static_cast<int64_t>(ts.tv_sec) * 1000000000ll + ts.tv_nsec;
  }
  inline void start() {
    if (ns) t0 = now();
  }
  inline void stop(int slot) {
    if (ns) {
      int64_t t = now();
      ns[slot] += t - t0;
      t0 = t;
    }
  }
};

// stage_ns slots (accumulated nanoseconds)
enum { ST_DECOMPRESS = 0, ST_LEVELS = 1, ST_PRESCAN = 2, ST_COPY = 3, ST_CRC = 4 };

}  // namespace

// Page-table column layout (int64[n_pages][18]); absent fields are 0 unless
// noted. Routes: 0 host-decoded ("other"), 1 dict indices (hybrid run table),
// 2 delta-bp (miniblock table), 3 PLAIN numeric (bytes in values_out),
// 4 empty (no non-null values).
enum {
  PC_KIND = 0,      // 0 data page, 1 dictionary page, 2 index page
  PC_N = 1,         // num_values incl. nulls
  PC_NONNULL = 2,
  PC_ENC = 3,
  PC_ROUTE = 4,
  PC_VOFF = 5,      // offset of this page's value bytes in values_out
  PC_VLEN = 6,
  PC_LVLBASE = 7,   // start index of this page's levels in def_out/rep_out
  PC_RUNS = 8,      // first hybrid run index (route 1)
  PC_RUNE = 9,
  PC_PACKS = 10,    // packed_out byte range of this page's bit-packed payloads
  PC_PACKE = 11,
  PC_MINIS = 12,    // first delta miniblock entry (route 2)
  PC_MINIE = 13,
  PC_DSTART = 14,   // delta_out byte offset of this page's stream
  PC_DCONS = 15,    // bytes of delta stream consumed
  PC_EXTRA = 16,    // route 1: dict index bit width; route 2: stream total
  PC_DFIRST = 17,   // route 2: first value (uint64 bit pattern)
};
#define PT_COLS 18

// Returns n_pages >= 0 on success. Negative: -1 corrupt/unsupported (caller
// falls back to the Python walk for exact errors), -2 page table full,
// -3 hybrid run table full, -4 delta miniblock table full, -5 level/value
// capacity exceeded (metadata understated the chunk), -6 stored page CRC
// mismatch (validate_crc only; definite corruption, not "unsupported").
// err_info (nullable int64[4]) reports {stage, page index, page byte offset
// in the chunk, 0} for any negative return — the structured error channel
// parquet-tool verify and the fallback-ladder counters consume.
ssize_t ptq_chunk_prepare(
    const uint8_t* src, size_t src_len,
    int codec,               // 0 UNCOMPRESSED, 1 SNAPPY, 2 GZIP
    int validate_crc,        // nonzero: verify stored page CRCs in the walk
    int max_def, int max_rep,
    int type_size,           // PLAIN itemsize for numeric types, else 0
    int delta_nbits,         // 32/64 when delta-bp is device-eligible, else 0
    int64_t expected_values, // level buffer capacity (metadata num_values)
    int64_t* pages, size_t max_pages,
    uint16_t* def_out, uint16_t* rep_out,
    uint8_t* values_out, size_t values_cap,
    uint8_t* packed_out, size_t packed_cap,
    uint8_t* delta_out, size_t delta_cap,
    uint8_t* scratch, size_t scratch_cap,
    uint8_t* h_is_rle, int64_t* h_counts, uint64_t* h_values,
    int64_t* h_byteoff, size_t max_runs,
    uint32_t* d_widths, int64_t* d_bytestart, int32_t* d_outstart,
    uint64_t* d_mins, size_t max_minis,
    int64_t* totals, /* [8]: lvl_total, values_used, packed_used, delta_used,
                        runs, minis, has_dict, reserved */
    int64_t* stage_ns, /* nullable [5]: accumulated ns per stage (decompress,
                          levels, prescan, copy, crc) for the bench breakdown */
    int64_t* err_info /* nullable [4]: see above */) {
  StageClock clk{stage_ns, 0};
  size_t pos = 0;
  size_t n_pages = 0;
  int64_t lvl_total = 0;
  size_t values_used = 0, packed_used = 0, delta_used = 0;
  size_t runs = 0, minis = 0;
  bool has_dict = false;
  int64_t slots[23];
  // Failure-context tracking: the walk keeps err[] current (stage, page,
  // page byte offset) so every `return negative` below reports where it
  // died without threading the detail through dozens of return sites.
  int64_t err_local[4];
  int64_t* err = err_info ? err_info : err_local;
  err[0] = PTQ_STAGE_NONE; err[1] = 0; err[2] = 0; err[3] = 0;

  while (pos < src_len) {
    err[0] = PTQ_STAGE_HEADER;
    err[1] = static_cast<int64_t>(n_pages);
    err[2] = static_cast<int64_t>(pos);
    ssize_t hrc = ptq_parse_page_header(src + pos, src_len - pos, slots);
    if (hrc != 0) return -1;  // truncated-within-chunk IS corrupt here
    size_t hlen = static_cast<size_t>(slots[0]);
    int64_t psize = slots[3];
    if (psize < 0 || pos + hlen + static_cast<uint64_t>(psize) > src_len) return -1;
    int64_t usize = slots[2] == INT64_MIN ? 0 : slots[2];
    if (usize < 0) return -1;
    const uint8_t* payload = src + pos + hlen;
    size_t payload_len = static_cast<size_t>(psize);
    pos += hlen + payload_len;
    if (n_pages >= max_pages) return -2;
    if (validate_crc && slots[4] != INT64_MIN) {
      // CRC over the page payload EXACTLY as stored (V1: the compressed
      // block; V2: raw rep+def level streams + compressed values) — the
      // parquet-format contract, byte-for-byte what core/chunk._check_crc
      // computes on the staged path.
      err[0] = PTQ_STAGE_CRC;
      clk.start();
      uLong crc = crc32(0L, Z_NULL, 0);
      size_t off = 0;
      while (off < payload_len) {
        size_t take = payload_len - off;
        if (take > (1u << 30)) take = 1u << 30;  // uInt-safe chunks
        crc = crc32(crc, payload + off, static_cast<uInt>(take));
        off += take;
      }
      clk.stop(ST_CRC);
      if (static_cast<uint32_t>(crc) !=
          static_cast<uint32_t>(static_cast<int64_t>(slots[4])))
        return PTQ_E_CRC;
    }
    int64_t* P = pages + n_pages * PT_COLS;
    std::memset(P, 0, PT_COLS * sizeof(int64_t));

    int64_t ptype = slots[1];
    if (ptype == 2) {  // DICTIONARY_PAGE
      // Must be the FIRST page: later routes assume their values_out regions
      // are contiguous, and a mid-chunk dict page would interleave. The spec
      // puts it first; anything else takes the Python walk.
      if (has_dict || n_pages != 0 || slots[10] != 1) return -1;
      has_dict = true;
      const uint8_t* block = payload;
      size_t block_len = payload_len;
      if (codec != 0) {
        err[0] = PTQ_STAGE_DECOMPRESS;
        clk.start();
        int rc = decompress_page(codec, payload, payload_len, scratch,
                                 scratch_cap, static_cast<size_t>(usize));
        clk.stop(ST_DECOMPRESS);
        if (rc != 0) return rc;
      }
      err[0] = PTQ_STAGE_VALUES;
      if (codec != 0) {
        block = scratch;
        block_len = static_cast<size_t>(usize);
      }
      if (values_used + block_len > values_cap) return -5;
      clk.start();
      std::memcpy(values_out + values_used, block, block_len);
      clk.stop(ST_COPY);
      P[PC_KIND] = 1;
      P[PC_N] = slots[11] == INT64_MIN ? 0 : slots[11];  // dict num_values
      P[PC_ENC] = slots[12] == INT64_MIN ? 0 : slots[12];
      P[PC_VOFF] = static_cast<int64_t>(values_used);
      P[PC_VLEN] = static_cast<int64_t>(block_len);
      values_used += block_len;
      n_pages++;
      continue;
    }
    if (ptype == 1) {  // INDEX_PAGE: skipped (parity with the Python walk)
      P[PC_KIND] = 2;
      n_pages++;
      continue;
    }
    if (ptype != 0 && ptype != 3) return -1;

    // -- data page: levels ---------------------------------------------------
    int64_t n, enc;
    const uint8_t* vsrc;      // value stream start
    size_t vlen;              // value stream length
    int64_t non_null;
    if (ptype == 0) {  // DATA_PAGE (V1): block = levels + values, compressed whole
      if (slots[5] != 1) return -1;
      n = slots[6] == INT64_MIN ? 0 : slots[6];
      enc = slots[7] == INT64_MIN ? -1 : slots[7];
      if (n < 0) return -1;
      const uint8_t* block = payload;
      size_t block_len = payload_len;
      if (codec != 0) {
        // level-free PLAIN numeric pages decompress STRAIGHT into their
        // final values_out slot: no scratch bounce, no second multi-MB
        // memcpy (the PLAIN route below detects the in-place block)
        uint8_t* dst = scratch;
        size_t dcap = scratch_cap;
        if (enc == 0 && type_size > 0 && max_rep == 0 && max_def == 0 &&
            values_used + static_cast<uint64_t>(usize) <= values_cap) {
          dst = values_out + values_used;
          dcap = values_cap - values_used;
        }
        err[0] = PTQ_STAGE_DECOMPRESS;
        clk.start();
        int rc = decompress_page(codec, payload, payload_len, dst, dcap,
                                 static_cast<size_t>(usize));
        clk.stop(ST_DECOMPRESS);
        if (rc != 0) return rc;
        block = dst;
        block_len = static_cast<size_t>(usize);
      }
      size_t cur = 0;
      err[0] = PTQ_STAGE_LEVELS;
      if (lvl_total + n > expected_values) return -5;
      clk.start();
      if (max_rep > 0) {
        if (block_len < cur + 4) return -1;
        uint32_t sz;
        std::memcpy(&sz, block + cur, 4);
        if (cur + 4 + sz > block_len) return -1;
        ssize_t used = decode_levels16(block + cur + 4, sz, n, max_rep,
                                       rep_out + lvl_total, -1, nullptr);
        if (used < 0) return -1;
        cur += 4 + sz;
      }
      non_null = n;
      if (max_def > 0) {
        if (block_len < cur + 4) return -1;
        uint32_t sz;
        std::memcpy(&sz, block + cur, 4);
        if (cur + 4 + sz > block_len) return -1;
        int64_t eq = 0;
        ssize_t used = decode_levels16(block + cur + 4, sz, n, max_def,
                                       def_out + lvl_total, max_def, &eq);
        if (used < 0) return -1;
        cur += 4 + sz;
        non_null = eq;
      }
      clk.stop(ST_LEVELS);
      err[0] = PTQ_STAGE_VALUES;
      vsrc = block + cur;
      vlen = block_len - cur;
    } else {  // DATA_PAGE_V2: levels raw, values optionally compressed
      if (slots[14] != 1) return -1;
      n = slots[15] == INT64_MIN ? 0 : slots[15];
      enc = slots[18] == INT64_MIN ? -1 : slots[18];
      if (n < 0) return -1;
      int64_t def_len = slots[19] == INT64_MIN ? 0 : slots[19];
      int64_t rep_len = slots[20] == INT64_MIN ? 0 : slots[20];
      int64_t is_comp = slots[21];  // absent -> compressed (parity: None => true)
      if (def_len < 0 || rep_len < 0 ||
          static_cast<uint64_t>(def_len) + static_cast<uint64_t>(rep_len) >
              payload_len)
        return -1;
      err[0] = PTQ_STAGE_LEVELS;
      if (lvl_total + n > expected_values) return -5;
      clk.start();
      if (max_rep > 0) {
        if (decode_levels16(payload, static_cast<size_t>(rep_len), n, max_rep,
                            rep_out + lvl_total, -1, nullptr) < 0)
          return -1;
      }
      non_null = n;
      if (max_def > 0) {
        int64_t eq = 0;
        if (decode_levels16(payload + rep_len, static_cast<size_t>(def_len), n,
                            max_def, def_out + lvl_total, max_def, &eq) < 0)
          return -1;
        non_null = eq;
      }
      // FLAT columns only: the V2 header's num_nulls must agree with the
      // decoded levels (parity with decode_data_page_v2's cross-check; for
      // repeated columns foreign writers count nulls differently, so the
      // levels are the only trustworthy source there). A mismatch means the
      // header or the level stream is lying — corrupt, not unsupported.
      if (max_rep == 0 && max_def > 0 && slots[16] != INT64_MIN &&
          n - non_null != slots[16])
        return -1;
      clk.stop(ST_LEVELS);
      const uint8_t* vreg = payload + rep_len + def_len;
      size_t vreg_len = payload_len - static_cast<size_t>(rep_len + def_len);
      if (codec != 0 && (is_comp == INT64_MIN || is_comp != 0)) {
        int64_t vexpect = usize - rep_len - def_len;
        if (vexpect < 0) vexpect = 0;
        // V2 keeps levels outside the compressed region, so PLAIN numeric
        // values can always land directly in values_out (see V1 note)
        uint8_t* dst = scratch;
        size_t dcap = scratch_cap;
        if (enc == 0 && type_size > 0 &&
            values_used + static_cast<uint64_t>(vexpect) <= values_cap) {
          dst = values_out + values_used;
          dcap = values_cap - values_used;
        }
        err[0] = PTQ_STAGE_DECOMPRESS;
        clk.start();
        int rc = decompress_page(codec, vreg, vreg_len, dst, dcap,
                                 static_cast<size_t>(vexpect));
        clk.stop(ST_DECOMPRESS);
        if (rc != 0) return rc;
        vsrc = dst;
        vlen = static_cast<size_t>(vexpect);
      } else {
        vsrc = vreg;
        vlen = vreg_len;
      }
      err[0] = PTQ_STAGE_VALUES;
    }

    P[PC_KIND] = 0;
    P[PC_N] = n;
    P[PC_NONNULL] = non_null;
    P[PC_ENC] = enc;
    P[PC_LVLBASE] = lvl_total;
    lvl_total += n;

    // -- route the value stream ---------------------------------------------
    if (enc == 8 || enc == 2) {  // RLE_DICTIONARY / PLAIN_DICTIONARY
      if (!has_dict) return -1;
      if (non_null == 0) {
        P[PC_ROUTE] = 4;
        n_pages++;
        continue;
      }
      if (vlen < 1) return -1;
      int width = vsrc[0];
      if (width > 32) return -1;
      const uint8_t* stream = vsrc + 1;
      size_t stream_len = vlen - 1;
      // Inline prescan: clamp counts so the page contributes exactly
      // non_null outputs; copy bit-packed payloads (only) into packed_out so
      // batch bit offsets are global (mirrors prescan_hybrid's compaction +
      // _HybridBatch.add_page's clamping in one pass).
      const size_t vbytes = (width + 7) / 8;
      size_t spos = 0;
      int64_t produced = 0;
      size_t run0 = runs, pack0 = packed_used;
      err[0] = PTQ_STAGE_PRESCAN;
      clk.start();
      while (produced < non_null) {
        uint64_t header = 0;
        int shift = 0;
        for (;;) {
          if (spos >= stream_len || shift > 63) return -1;
          uint8_t b = stream[spos++];
          if (shift == 63 && (b & 0x7e)) return -1;
          header |= static_cast<uint64_t>(b & 0x7f) << shift;
          if (!(b & 0x80)) break;
          shift += 7;
        }
        if (runs >= max_runs) return -3;
        int64_t take;
        if (header & 1) {
          uint64_t groups = header >> 1;
          if (groups == 0 || groups > (1ull << 40)) return -1;
          uint64_t count = groups * 8;
          uint64_t nbytes = groups * static_cast<uint64_t>(width);
          if (spos + nbytes > stream_len) return -1;
          take = non_null - produced;
          if (static_cast<uint64_t>(take) > count) take = static_cast<int64_t>(count);
          if (packed_used + nbytes > packed_cap) return -5;
          std::memcpy(packed_out + packed_used, stream + spos, nbytes);
          h_is_rle[runs] = 0;
          h_counts[runs] = take;
          h_values[runs] = 0;
          h_byteoff[runs] = static_cast<int64_t>(packed_used);
          packed_used += nbytes;
          spos += nbytes;
        } else {
          uint64_t count = header >> 1;
          if (count == 0 || count > (1ull << 40) || spos + vbytes > stream_len)
            return -1;
          uint64_t v = 0;
          for (size_t i = 0; i < vbytes; i++)
            v |= static_cast<uint64_t>(stream[spos + i]) << (8 * i);
          if (width < 64 && v >= (1ull << width)) return -1;
          spos += vbytes;
          take = non_null - produced;
          if (static_cast<uint64_t>(take) > count) take = static_cast<int64_t>(count);
          h_is_rle[runs] = 1;
          h_counts[runs] = take;
          h_values[runs] = v;
          h_byteoff[runs] = 0;
        }
        runs++;
        produced += take;
      }
      clk.stop(ST_PRESCAN);
      P[PC_ROUTE] = 1;
      P[PC_RUNS] = static_cast<int64_t>(run0);
      P[PC_RUNE] = static_cast<int64_t>(runs);
      P[PC_PACKS] = static_cast<int64_t>(pack0);
      P[PC_PACKE] = static_cast<int64_t>(packed_used);
      P[PC_EXTRA] = width;
    } else if (enc == 5 && delta_nbits != 0) {  // DELTA_BINARY_PACKED
      uint64_t first = 0;
      int64_t total = 0, consumed = 0;
      size_t mini0 = minis;
      // prescan against max_minis - minis remaining slots
      err[0] = PTQ_STAGE_PRESCAN;
      clk.start();
      ssize_t m = ptq_prescan_delta_packed(
          vsrc, vlen, delta_nbits, non_null, d_widths + minis,
          d_bytestart + minis, d_outstart + minis, d_mins + minis,
          max_minis - minis, &first, &total, &consumed);
      clk.stop(ST_PRESCAN);
      if (m == -2) return -4;
      if (m < 0) return -1;
      err[0] = PTQ_STAGE_VALUES;
      // byte starts are relative to the page's stream: rebase into delta_out
      if (delta_used + static_cast<size_t>(consumed) > delta_cap) return -5;
      clk.start();
      std::memcpy(delta_out + delta_used, vsrc, static_cast<size_t>(consumed));
      clk.stop(ST_COPY);
      for (ssize_t i = 0; i < m; i++)
        d_bytestart[mini0 + i] += static_cast<int64_t>(delta_used);
      P[PC_ROUTE] = 2;
      P[PC_MINIS] = static_cast<int64_t>(mini0);
      P[PC_MINIE] = static_cast<int64_t>(mini0 + m);
      P[PC_DSTART] = static_cast<int64_t>(delta_used);
      P[PC_DCONS] = consumed;
      P[PC_EXTRA] = total;
      P[PC_DFIRST] = static_cast<int64_t>(first);
      delta_used += static_cast<size_t>(consumed);
      minis += static_cast<size_t>(m);
    } else if (enc == 0 && type_size > 0) {  // PLAIN numeric
      size_t need = static_cast<size_t>(non_null) * type_size;
      if (vlen < need) return -1;  // "plain payload too short"
      if (values_used + need > values_cap) return -5;
      if (vsrc != values_out + values_used) {  // direct decompress: in place
        clk.start();
        std::memcpy(values_out + values_used, vsrc, need);
        clk.stop(ST_COPY);
      }
      P[PC_ROUTE] = 3;
      P[PC_VOFF] = static_cast<int64_t>(values_used);
      P[PC_VLEN] = static_cast<int64_t>(need);
      values_used += need;
    } else if (enc == 9 && type_size == 4) {  // BYTE_STREAM_SPLIT, 4-byte
      // Ship the page's interleaved streams RAW (route 5): the transpose is
      // pure layout, and the device does it as a reshape+transpose for free
      // — the host never strides over the bytes at all. 8-byte BSS stays
      // host-side below (TPU x64 emulation cannot bitcast u8x8 lanes).
      size_t need = static_cast<size_t>(non_null) * type_size;
      if (vlen < need) return -1;
      if (values_used + need > values_cap) return -5;
      if (vsrc != values_out + values_used) {
        clk.start();
        std::memcpy(values_out + values_used, vsrc, need);
        clk.stop(ST_COPY);
      }
      P[PC_ROUTE] = 5;
      P[PC_VOFF] = static_cast<int64_t>(values_used);
      P[PC_VLEN] = static_cast<int64_t>(need);
      values_used += need;
    } else if (enc == 9 && type_size > 0) {  // BYTE_STREAM_SPLIT, 8-byte
      // De-interleave the byte streams back to PLAIN little-endian layout
      // in one strided pass; the page then rides the PLAIN device route
      // (the transform is pure layout, so doing it here keeps byte-identity
      // with the host decoder for free).
      size_t need = static_cast<size_t>(non_null) * type_size;
      if (vlen < need) return -1;
      if (values_used + need > values_cap) return -5;
      uint8_t* dstv = values_out + values_used;
      const size_t nn = static_cast<size_t>(non_null);
      clk.start();
      for (int b = 0; b < type_size; b++) {
        const uint8_t* sp = vsrc + static_cast<size_t>(b) * nn;
        for (size_t i = 0; i < nn; i++) dstv[i * type_size + b] = sp[i];
      }
      clk.stop(ST_COPY);
      P[PC_ROUTE] = 3;
      P[PC_VOFF] = static_cast<int64_t>(values_used);
      P[PC_VLEN] = static_cast<int64_t>(need);
      values_used += need;
    } else {  // anything else: stream bytes for the Python host decoder
      if (values_used + vlen > values_cap) return -5;
      clk.start();
      std::memcpy(values_out + values_used, vsrc, vlen);
      clk.stop(ST_COPY);
      P[PC_ROUTE] = 0;
      P[PC_VOFF] = static_cast<int64_t>(values_used);
      P[PC_VLEN] = static_cast<int64_t>(vlen);
      values_used += vlen;
    }
    n_pages++;
  }

  totals[0] = lvl_total;
  totals[1] = static_cast<int64_t>(values_used);
  totals[2] = static_cast<int64_t>(packed_used);
  totals[3] = static_cast<int64_t>(delta_used);
  totals[4] = static_cast<int64_t>(runs);
  totals[5] = static_cast<int64_t>(minis);
  totals[6] = has_dict ? 1 : 0;
  totals[7] = 0;
  return static_cast<ssize_t>(n_pages);
}


// ---------------------------------------------------------------------------
// DELTA_BINARY_PACKED encoder (the PLAIN->delta transfer repack). Byte-
// identical to the NumPy reference encoder in ops/delta.py.
// ---------------------------------------------------------------------------

// DELTA_BINARY_PACKED encode (mirrors ops/delta.py encode_delta
// byte-for-byte, including wrapping min-delta arithmetic and zero-width
// trailing miniblocks). vals is int32[n] or int64[n] by nbits. Returns
// bytes written, -1 bad args, -2 out_cap too small.
ssize_t ptq_delta_encode(const void* vals, int64_t n, int nbits,
                         int64_t block_size, int64_t mini_count,
                         uint8_t* out, size_t out_cap) {
  if (nbits != 32 && nbits != 64) return -1;
  // mini_count capped at 512 like every decoder (and the widths[] buffer)
  if (block_size <= 0 || mini_count <= 0 || mini_count > 512 ||
      block_size % mini_count)
    return -1;
  const int64_t mini_len = block_size / mini_count;
  if (mini_len % 8) return -1;
  const uint64_t mask = (nbits == 64) ? ~0ull : ((1ull << nbits) - 1);
  const int32_t* v32 = (nbits == 32) ? static_cast<const int32_t*>(vals) : nullptr;
  const int64_t* v64 = (nbits == 64) ? static_cast<const int64_t*>(vals) : nullptr;
  auto get = [&](int64_t i) -> uint64_t {
    return (v32 ? static_cast<uint64_t>(static_cast<uint32_t>(v32[i]))
                : static_cast<uint64_t>(v64[i])) & mask;
  };
  size_t pos = 0;
  if (!put_uvarint(out, out_cap, &pos, static_cast<uint64_t>(block_size))) return -2;
  if (!put_uvarint(out, out_cap, &pos, static_cast<uint64_t>(mini_count))) return -2;
  if (!put_uvarint(out, out_cap, &pos, static_cast<uint64_t>(n))) return -2;
  uint64_t first = n ? get(0) : 0;
  int64_t sfirst = static_cast<int64_t>(first);
  if (nbits < 64 && first >= (1ull << (nbits - 1)))
    sfirst = static_cast<int64_t>(first) - (1ll << nbits);
  if (!put_zigzag(out, out_cap, &pos, sfirst)) return -2;
  if (n <= 1) return static_cast<ssize_t>(pos);

  const int64_t n_deltas = n - 1;
  // per-block delta cache: one subtraction per element instead of re-reading
  // both neighbors in every one of the three scans below (min, width, pack)
  uint64_t dstack[4096];
  uint64_t* dheap = nullptr;
  uint64_t* dbuf = dstack;
  if (block_size > 4096) {
    dheap = static_cast<uint64_t*>(malloc(static_cast<size_t>(block_size) * 8));
    if (!dheap) return -2;
    dbuf = dheap;
  }
  for (int64_t bs = 0; bs < n_deltas; bs += block_size) {
    int64_t blen = n_deltas - bs < block_size ? n_deltas - bs : block_size;
    // one pass: deltas into the cache + signed min of the wrapping deltas
    int64_t min_s = 0;
    uint64_t dmin_u = 0;
    {
      bool have = false;
      uint64_t prev = get(bs);
      for (int64_t k = 0; k < blen; k++) {
        uint64_t cur = get(bs + k + 1);
        uint64_t d = (cur - prev) & mask;
        prev = cur;
        dbuf[k] = d;
        int64_t s = static_cast<int64_t>(d);
        if (nbits < 64 && d >= (1ull << (nbits - 1)))
          s = static_cast<int64_t>(d) - (1ll << nbits);
        if (!have || s < min_s) { have = true; min_s = s; dmin_u = d; }
      }
    }
    if (!put_zigzag(out, out_cap, &pos, min_s)) { free(dheap); return -2; }
    // per-miniblock widths, then payloads
    uint8_t widths[512];
    size_t wpos = pos;
    if (pos + static_cast<size_t>(mini_count) > out_cap) { free(dheap); return -2; }
    pos += static_cast<size_t>(mini_count);
    for (int64_t m = 0; m < mini_count; m++) {
      int64_t mstart = m * mini_len;
      int64_t mlen = blen - mstart;
      if (mlen <= 0) { widths[m] = 0; continue; }
      if (mlen > mini_len) mlen = mini_len;
      uint64_t mx = 0;
      for (int64_t k = 0; k < mlen; k++) {
        uint64_t adj = (dbuf[mstart + k] - dmin_u) & mask;
        if (adj > mx) mx = adj;
      }
      int w = 0;
      while (mx) { w++; mx >>= 1; }
      widths[m] = static_cast<uint8_t>(w);
      if (w == 0) continue;
      BitWriter bw;
      bw_init(&bw, out, out_cap, pos);
      for (int64_t k = 0; k < mini_len; k++) {
        uint64_t adj = 0;
        if (k < mlen) adj = (dbuf[mstart + k] - dmin_u) & mask;
        if (!bw_push(&bw, adj, w)) { free(dheap); return -2; }
      }
      if (!bw_flush(&bw)) { free(dheap); return -2; }
      pos = bw.pos;
    }
    for (int64_t m = 0; m < mini_count; m++) out[wpos + m] = widths[m];
  }
  free(dheap);
  return static_cast<ssize_t>(pos);
}

}  // extern "C"
