/* Bit-stream and varint helpers shared by the host library's two sources
 * (prepare.cc, the chunk walk and the DELTA encoder; values.cc, the value
 * functions). Copied from the JAX package's native/parquet_tpu_native.cc:
 * an LSB-first bit reader and writer in parquet's bit-packed order, and
 * ULEB128 / zigzag varints. Every definition is static inline, so each
 * source compiles its own copy and the library exports none of them.
 */
#ifndef PARQUET_TPU_TORCH_BITS_H
#define PARQUET_TPU_TORCH_BITS_H

#include <stddef.h>
#include <stdint.h>

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

#endif /* PARQUET_TPU_TORCH_BITS_H */
