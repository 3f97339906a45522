/* Helpers shared by the host library's three sources (prepare.cc, the chunk
 * walk and the DELTA encoder; values.cc, the value functions; encode.cc, the
 * fused chunk encode walk). Copied from the JAX package's
 * native/parquet_tpu_native.cc: an LSB-first bit reader and writer in
 * parquet's bit-packed order, ULEB128 / zigzag varints, the level bit width,
 * the per-stage wall clock of the two chunk walks, and the element-generic
 * hybrid RLE/bit-pack encoder. Every function is static inline, so each
 * source compiles its own copy and the library exports none of them.
 */
#ifndef PARQUET_TPU_TORCH_BITS_H
#define PARQUET_TPU_TORCH_BITS_H

#include <stddef.h>
#include <stdint.h>
#include <sys/types.h>  // ssize_t
#include <time.h>       // StageClock

// ---------------------------------------------------------------------------
// bit-stream reader (LSB-first, parquet bit-packed order)
// ---------------------------------------------------------------------------

struct BitReader {
  const uint8_t* src;
  size_t len;
  size_t pos;     // next byte
  uint64_t buf;   // pending bits, LSB first
  int bits;       // number of pending bits
};

static inline void br_init(BitReader* r, const uint8_t* src, size_t len) {
  r->src = src; r->len = len; r->pos = 0; r->buf = 0; r->bits = 0;
}

// Reads `w` bits (0 <= w <= 64). Caller guarantees the underlying payload is
// in bounds (all call sites bounds-check the whole run/miniblock first).
static inline uint64_t br_read(BitReader* r, int w) {
  uint64_t v = 0;
  int got = 0;
  while (got < w) {
    if (r->bits == 0) {
      r->buf = r->src[r->pos++];
      r->bits = 8;
    }
    int take = w - got;
    if (take > r->bits) take = r->bits;
    v |= (r->buf & ((take == 64) ? ~0ull : ((1ull << take) - 1))) << got;
    r->buf >>= take;
    r->bits -= take;
    got += take;
  }
  return v;
}

static inline bool read_uvarint64(const uint8_t* src, size_t src_len, size_t* pos,
                                  uint64_t* out) {
  uint64_t v = 0;
  int shift = 0;
  for (;;) {
    if (*pos >= src_len || shift > 63) return false;
    uint8_t b = src[(*pos)++];
    if (shift == 63 && (b & 0x7e)) return false;  // overflows uint64
    v |= static_cast<uint64_t>(b & 0x7f) << shift;
    if (!(b & 0x80)) break;
    shift += 7;
  }
  *out = v;
  return true;
}

// ---------------------------------------------------------------------------
// bit-stream writer and varint emitters (the encoders)
// ---------------------------------------------------------------------------

static inline bool put_uvarint(uint8_t* out, size_t cap, size_t* pos, uint64_t v) {
  while (v >= 0x80) {
    if (*pos >= cap) return false;
    out[(*pos)++] = static_cast<uint8_t>(v | 0x80);
    v >>= 7;
  }
  if (*pos >= cap) return false;
  out[(*pos)++] = static_cast<uint8_t>(v);
  return true;
}

static inline bool put_zigzag(uint8_t* out, size_t cap, size_t* pos, int64_t v) {
  uint64_t u = (static_cast<uint64_t>(v) << 1) ^ static_cast<uint64_t>(v >> 63);
  return put_uvarint(out, cap, pos, u);
}

struct BitWriter {
  uint8_t* out;
  size_t cap;
  size_t pos;
  unsigned __int128 acc;
  int nbits;
};

static inline void bw_init(BitWriter* w, uint8_t* out, size_t cap, size_t pos) {
  w->out = out; w->cap = cap; w->pos = pos; w->acc = 0; w->nbits = 0;
}

static inline bool bw_push(BitWriter* w, uint64_t v, int width) {
  w->acc |= static_cast<unsigned __int128>(v) << w->nbits;
  w->nbits += width;
  while (w->nbits >= 8) {
    if (w->pos >= w->cap) return false;
    w->out[w->pos++] = static_cast<uint8_t>(w->acc);
    w->acc >>= 8;
    w->nbits -= 8;
  }
  return true;
}

static inline bool bw_flush(BitWriter* w) {
  if (w->nbits > 0) {
    if (w->pos >= w->cap) return false;
    w->out[w->pos++] = static_cast<uint8_t>(w->acc);
    w->acc = 0;
    w->nbits = 0;
  }
  return true;
}

static inline int level_bit_width(int max_level) {
  int w = 0;
  while (max_level) { w++; max_level >>= 1; }  // bit_length
  return w;
}

// Per-stage wall clock for the whole-chunk walks. All accounting is skipped
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

// ---------------------------------------------------------------------------
// hybrid RLE/bit-pack encode (the write path's level and index streams)
// ---------------------------------------------------------------------------

// One bit-packed segment: header (groups<<1)|1 then LSB-first payload,
// zero-padding the final partial group (mirrors _emit_bitpacked). The
// element getter is size-generic so the fused encode walk packs uint16
// level streams and uint32 dictionary indices without first widening them
// to uint64 (the widening copy of a 1M-row index column was measurable).
static inline uint64_t he_get(const void* v, int es, int64_t i) {
  switch (es) {
    case 2: return static_cast<const uint16_t*>(v)[i];
    case 4: return static_cast<const uint32_t*>(v)[i];
    default: return static_cast<const uint64_t*>(v)[i];
  }
}

static inline bool emit_bitpacked_any(const void* v, int es, int64_t n, int width,
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
        uint64_t x = he_get(v, es, g + k);
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
        uint64_t x = he_get(v, es, i);
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
    uint64_t x = he_get(v, es, i);
    if (width < 64 && (x >> width)) { *bad_value = true; return false; }
    if (!bw_push(&w, x, width)) return false;
  }
  for (int64_t i = n; i < padded; i++)
    if (!bw_push(&w, 0, width)) return false;
  if (!bw_flush(&w)) return false;
  *pos = w.pos;
  return true;
}

// Element-size-generic hybrid encode core: the one implementation behind
// ptq_hybrid_encode (values.cc, es=8) and the fused encode walk (encode.cc,
// es=2/4), so the two cannot drift on bytes.
static inline ssize_t hybrid_encode_any(const void* vals, int es, int64_t n,
                                 int width, uint8_t* out, size_t out_cap) {
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
    const uint64_t cur = he_get(vals, es, i);
    while (j < n && he_get(vals, es, j) == cur) j++;
    if (j - i >= 8) {
      // 8-align the RLE window so surrounding bit-packed segments stay
      // multiples of 8 values (mid-stream padding would shift the stream)
      int64_t rle_start = (i + 7) & ~7ll;
      int64_t rle_end = j & ~7ll;
      if (rle_end - rle_start >= 8) {
        if (rle_start > seg &&
            !emit_bitpacked_any(static_cast<const uint8_t*>(vals) + seg * es,
                                es, rle_start - seg, width, out, out_cap,
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
      !emit_bitpacked_any(static_cast<const uint8_t*>(vals) + seg * es, es,
                          n - seg, width, out, out_cap, &pos, &bad))
    return bad ? -1 : -2;
  return static_cast<ssize_t>(pos);
}

#endif /* PARQUET_TPU_TORCH_BITS_H */
