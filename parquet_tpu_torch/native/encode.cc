// Fused whole-chunk encode walk of parquet_tpu_torch: the write-side inverse
// of prepare.cc's ptq_chunk_prepare, and the gzip compressor it uses.
//
// A cut-down copy of the JAX package's native/parquet_tpu_native.cc (the
// port carries its own copy and never loads that library): ptq_chunk_encode
// does page split -> def-level hybrid pack -> value-stream encode -> block
// compression (UNCOMPRESSED / SNAPPY / GZIP) -> compact-Thrift page framing
// in one GIL-free call, every byte identical to the staged Python encoder
// (sink/encoder.py), which stays the fallback rung and the error-semantics
// oracle. ptq_gzip_compress exposes the walk's deflate so the Python side
// can check once that it matches CPython's zlib byte for byte.
//
// Linked with prepare.cc and values.cc into one library (libpqt_host.so) by
// parquet_tpu_torch/kernels/host_build.py and bound with ctypes in
// parquet_tpu_torch/utils/native.py. Every stage validates sizes before
// writing and returns a negative code (prepare.h PTQ_E_*) on bad input.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cstddef>
#include <sys/types.h>  // ssize_t
#include <zlib.h>       // deflate (GZIP pages) and crc32 (page CRCs)

#include "bits.h"     // varints, the stage clock, the hybrid encoder
#include "encode.h"   // ptq_chunk_encode / ptq_gzip_compress prototypes
#include "prepare.h"  // PTQ_E_* return codes

extern "C" {

namespace {

// Minimal compact-Thrift writer for PageHeader framing (the write twin of
// ptq_parse_page_header). Field ids here are small and ascending, so the
// short-form field header (delta << 4 | wire) always applies.
struct ThriftW {
  uint8_t* out;
  size_t cap;
  size_t pos;
  int last_fid;
  bool ok;
};

inline void th_init(ThriftW* w, uint8_t* out, size_t cap, size_t pos) {
  w->out = out; w->cap = cap; w->pos = pos; w->last_fid = 0; w->ok = true;
}

inline void th_byte(ThriftW* w, uint8_t b) {
  if (w->pos >= w->cap) { w->ok = false; return; }
  w->out[w->pos++] = b;
}

inline void th_field(ThriftW* w, int fid, int wire) {
  th_byte(w, static_cast<uint8_t>(((fid - w->last_fid) << 4) | wire));
  w->last_fid = fid;
}

inline void th_i32(ThriftW* w, int fid, int64_t v) {
  th_field(w, fid, 0x05);  // CT_I32
  if (!w->ok) return;
  if (!put_zigzag(w->out, w->cap, &w->pos, v)) w->ok = false;
}

inline void th_bool(ThriftW* w, int fid, bool v) {
  th_field(w, fid, v ? 0x01 : 0x02);  // value rides the field header
}

inline void th_stop(ThriftW* w) { th_byte(w, 0x00); }

// Compress one raw block into dst. Returns compressed size, -1 unknown
// codec, -5 dst too small / deflate failure (retryable capacity).
ssize_t compress_block_enc(int codec, const uint8_t* raw, size_t raw_len,
                           uint8_t* dst, size_t dst_cap) {
  if (codec == 0) {
    if (raw_len > dst_cap) return -5;
    std::memcpy(dst, raw, raw_len);
    return static_cast<ssize_t>(raw_len);
  }
  if (codec == 1) {
    ssize_t n = ptq_snappy_compress(reinterpret_cast<const char*>(raw),
                                    raw_len, reinterpret_cast<char*>(dst),
                                    dst_cap);
    return n < 0 ? -5 : n;
  }
  if (codec == 2) {
    // the exact parameters CPython's zlib.compressobj(wbits=31) resolves
    // to (default level/memLevel/strategy); both link the same zlib, so
    // the stream — gzip header included — is byte-identical to _Gzip
    z_stream s;
    std::memset(&s, 0, sizeof(s));
    if (deflateInit2(&s, Z_DEFAULT_COMPRESSION, Z_DEFLATED, 31, 8,
                     Z_DEFAULT_STRATEGY) != Z_OK)
      return -5;
    s.next_in = const_cast<Bytef*>(raw);
    s.avail_in = static_cast<uInt>(raw_len);
    s.next_out = dst;
    s.avail_out = static_cast<uInt>(dst_cap);
    int rc = deflate(&s, Z_FINISH);
    ssize_t n = static_cast<ssize_t>(s.total_out);
    deflateEnd(&s);
    return rc == Z_STREAM_END ? n : -5;
  }
  return -1;
}

// stage_ns slots for the encode walk
enum {
  EN_LEVELS = 0,
  EN_VALUES = 1,
  EN_COMPRESS = 2,
  EN_FRAME = 3,
  EN_CRC = 4,
};

}  // namespace

// Standalone gzip compress with the exact parameters the fused encode walk
// uses — exported so the Python side can PROBE byte-identity against
// zlib.compressobj(wbits=31) once at startup (a CPython linked against a
// different zlib build must keep GZIP on the staged encoder). Returns
// compressed size or -1.
ssize_t ptq_gzip_compress(const uint8_t* src, size_t src_len, uint8_t* dst,
                          size_t dst_cap) {
  ssize_t n = compress_block_enc(2, src, src_len, dst, dst_cap);
  return n < 0 ? -1 : n;
}

ssize_t ptq_chunk_encode(
    int route, const uint8_t* values, size_t values_len,
    const int64_t* ba_offsets, int64_t nv, int type_size, int dict_width,
    const uint8_t* dict_raw, size_t dict_raw_len, int64_t dict_num,
    const uint16_t* def_levels, int64_t num_entries, int max_def, int codec,
    int dpv, int with_crc, int64_t per_page, uint8_t* out, size_t out_cap,
    uint8_t* scratch, size_t scratch_cap, int64_t* pages, size_t max_pages,
    int64_t* totals, int64_t* stage_ns, int64_t* err_info) {
  StageClock clk{stage_ns, 0};
  int64_t page_idx = 0;
#define ENC_FAIL(code, stage_)                         \
  do {                                                 \
    if (err_info) {                                    \
      err_info[0] = (stage_);                          \
      err_info[1] = page_idx;                          \
      err_info[2] = 0;                                 \
      err_info[3] = 0;                                 \
    }                                                  \
    return (code);                                     \
  } while (0)

  if (route < 0 || route > 4 || (codec != 0 && codec != 1 && codec != 2) ||
      (dpv != 1 && dpv != 2) || per_page < 1 || num_entries < 0 || nv < 0 ||
      max_def < 0 || (max_def > 0 && def_levels == nullptr) ||
      (max_def == 0 && nv != num_entries))
    ENC_FAIL(PTQ_E_CORRUPT, PTQ_ENC_STAGE_SPLIT);
  if (route == 0 && (type_size < 1 || type_size > 4096))
    ENC_FAIL(PTQ_E_CORRUPT, PTQ_ENC_STAGE_SPLIT);
  if (route == 3 && type_size != 4 && type_size != 8)
    ENC_FAIL(PTQ_E_CORRUPT, PTQ_ENC_STAGE_SPLIT);
  if (route == 4 && type_size != 2)
    ENC_FAIL(PTQ_E_CORRUPT, PTQ_ENC_STAGE_SPLIT);
  if (route == 2 && (dict_width < 0 || dict_width > 32))
    ENC_FAIL(PTQ_E_CORRUPT, PTQ_ENC_STAGE_SPLIT);
  if (route == 1) {
    if (ba_offsets == nullptr || ba_offsets[0] != 0 ||
        static_cast<size_t>(ba_offsets[nv]) > values_len)
      ENC_FAIL(PTQ_E_CORRUPT, PTQ_ENC_STAGE_SPLIT);
  } else {
    size_t es = route == 2 ? 4 : static_cast<size_t>(type_size);
    if (static_cast<size_t>(nv) * es > values_len)
      ENC_FAIL(PTQ_E_CORRUPT, PTQ_ENC_STAGE_SPLIT);
  }

  // scratch splits into a raw-page half and a compressed half: the raw
  // block assembles first (levels + values), then compresses, then the
  // header (whose varints need the compressed size) frames into `out`.
  uint8_t* raw_buf = scratch;
  size_t raw_cap = scratch_cap / 2;
  uint8_t* comp_buf = scratch + raw_cap;
  size_t comp_cap = scratch_cap - raw_cap;

  size_t pos = 0;
  int64_t uncompressed_total = 0;
  int64_t dict_off = -1;
  const int def_width = level_bit_width(max_def);

  // -- leading dictionary page ----------------------------------------------
  if (route == 2 && dict_num > 0) {
    clk.start();
    ssize_t comp = compress_block_enc(codec, dict_raw, dict_raw_len,
                                      comp_buf, comp_cap);
    if (comp < 0) ENC_FAIL(comp == -1 ? PTQ_E_CORRUPT : PTQ_E_CAPACITY,
                           PTQ_ENC_STAGE_COMPRESS);
    clk.stop(EN_COMPRESS);
    uint32_t crc = 0;
    if (with_crc) {
      crc = static_cast<uint32_t>(crc32(0, comp_buf, static_cast<uInt>(comp)));
      clk.stop(EN_CRC);
    }
    ThriftW w;
    th_init(&w, out, out_cap, pos);
    th_i32(&w, 1, 2);                                 // type = DICTIONARY_PAGE
    th_i32(&w, 2, static_cast<int64_t>(dict_raw_len));  // uncompressed size
    th_i32(&w, 3, comp);                              // compressed size
    if (with_crc) th_i32(&w, 4, static_cast<int32_t>(crc));
    th_field(&w, 7, 0x0C);                            // dictionary_page_header
    w.last_fid = 0;
    th_i32(&w, 1, dict_num);
    th_i32(&w, 2, 0);                                 // encoding = PLAIN
    th_bool(&w, 3, false);                            // is_sorted
    th_stop(&w);
    w.last_fid = 7;
    th_stop(&w);
    if (!w.ok || w.pos + static_cast<size_t>(comp) > out_cap)
      ENC_FAIL(PTQ_E_CAPACITY, PTQ_ENC_STAGE_FRAME);
    size_t hdr_len = w.pos - pos;
    std::memcpy(out + w.pos, comp_buf, static_cast<size_t>(comp));
    dict_off = static_cast<int64_t>(pos);
    pos = w.pos + static_cast<size_t>(comp);
    uncompressed_total +=
        static_cast<int64_t>(hdr_len) + static_cast<int64_t>(dict_raw_len);
    clk.stop(EN_FRAME);
    totals[5] = static_cast<int64_t>(hdr_len) + comp;
  } else {
    totals[5] = 0;
  }
  const int64_t data_off = static_cast<int64_t>(pos);

  // -- page split (mirrors _split_pages for flat columns) --------------------
  const int64_t n = num_entries;
  int64_t vpos = 0;  // non-null value cursor
  int64_t a = 0;
  bool first = true;
  while (first || a < n) {
    first = false;
    int64_t b = n;
    if (n > per_page) {
      b = a + per_page;
      if (b > n) b = n;
    }
    // per-page non-null count
    int64_t nn;
    if (max_def > 0) {
      clk.start();
      nn = 0;
      for (int64_t i = a; i < b; i++) nn += (def_levels[i] == max_def);
      clk.stop(EN_LEVELS);
    } else {
      nn = b - a;
    }
    if (vpos + nn > nv) ENC_FAIL(PTQ_E_CORRUPT, PTQ_ENC_STAGE_SPLIT);

    // -- assemble the raw block into raw_buf --------------------------------
    size_t raw_pos = 0;
    size_t def_block_len = 0;
    if (max_def > 0) {
      clk.start();
      if (dpv == 1) {
        if (raw_pos + 4 > raw_cap) ENC_FAIL(PTQ_E_CAPACITY, PTQ_ENC_STAGE_LEVELS);
        raw_pos += 4;  // back-patched length prefix
      }
      ssize_t ln = hybrid_encode_any(def_levels + a, 2, b - a, def_width,
                                     raw_buf + raw_pos, raw_cap - raw_pos);
      if (ln < 0) ENC_FAIL(ln == -1 ? PTQ_E_CORRUPT : PTQ_E_CAPACITY,
                           PTQ_ENC_STAGE_LEVELS);
      def_block_len = static_cast<size_t>(ln);
      if (dpv == 1) {
        uint32_t l32 = static_cast<uint32_t>(def_block_len);
        raw_buf[raw_pos - 4] = static_cast<uint8_t>(l32);
        raw_buf[raw_pos - 3] = static_cast<uint8_t>(l32 >> 8);
        raw_buf[raw_pos - 2] = static_cast<uint8_t>(l32 >> 16);
        raw_buf[raw_pos - 1] = static_cast<uint8_t>(l32 >> 24);
        def_block_len += 4;  // v1 counts the prefix inside the block
      }
      raw_pos += static_cast<size_t>(ln);
      clk.stop(EN_LEVELS);
    }
    size_t values_start = raw_pos;
    clk.start();
    if (route == 0) {
      size_t nbytes = static_cast<size_t>(nn) * type_size;
      if (raw_pos + nbytes > raw_cap) ENC_FAIL(PTQ_E_CAPACITY, PTQ_ENC_STAGE_VALUES);
      std::memcpy(raw_buf + raw_pos, values + vpos * type_size, nbytes);
      raw_pos += nbytes;
    } else if (route == 1) {
      for (int64_t i = vpos; i < vpos + nn; i++) {
        int64_t off = ba_offsets[i];
        int64_t len = ba_offsets[i + 1] - off;
        if (len < 0 || off < 0 ||
            static_cast<size_t>(off + len) > values_len)
          ENC_FAIL(PTQ_E_CORRUPT, PTQ_ENC_STAGE_VALUES);
        if (raw_pos + 4 + static_cast<size_t>(len) > raw_cap)
          ENC_FAIL(PTQ_E_CAPACITY, PTQ_ENC_STAGE_VALUES);
        uint32_t l32 = static_cast<uint32_t>(len);
        raw_buf[raw_pos++] = static_cast<uint8_t>(l32);
        raw_buf[raw_pos++] = static_cast<uint8_t>(l32 >> 8);
        raw_buf[raw_pos++] = static_cast<uint8_t>(l32 >> 16);
        raw_buf[raw_pos++] = static_cast<uint8_t>(l32 >> 24);
        std::memcpy(raw_buf + raw_pos, values + off, static_cast<size_t>(len));
        raw_pos += static_cast<size_t>(len);
      }
    } else if (route == 2) {
      if (raw_pos + 1 > raw_cap) ENC_FAIL(PTQ_E_CAPACITY, PTQ_ENC_STAGE_VALUES);
      raw_buf[raw_pos++] = static_cast<uint8_t>(dict_width);
      ssize_t ln = hybrid_encode_any(
          reinterpret_cast<const uint32_t*>(values) + vpos, 4, nn, dict_width,
          raw_buf + raw_pos, raw_cap - raw_pos);
      if (ln < 0) ENC_FAIL(ln == -1 ? PTQ_E_CORRUPT : PTQ_E_CAPACITY,
                           PTQ_ENC_STAGE_VALUES);
      raw_pos += static_cast<size_t>(ln);
    } else if (route == 4) {
      // BOOLEAN RLE: hybrid stream at width 1 behind a 4-byte LE length
      // prefix (the prefix is part of the VALUE encoding, so unlike def
      // levels it stays in BOTH page versions — ops/levels.py
      // encode_levels_v1 is the byte oracle)
      if (raw_pos + 4 > raw_cap) ENC_FAIL(PTQ_E_CAPACITY, PTQ_ENC_STAGE_VALUES);
      raw_pos += 4;  // back-patched length prefix
      ssize_t ln = hybrid_encode_any(
          reinterpret_cast<const uint16_t*>(values) + vpos, 2, nn, 1,
          raw_buf + raw_pos, raw_cap - raw_pos);
      if (ln < 0) ENC_FAIL(ln == -1 ? PTQ_E_CORRUPT : PTQ_E_CAPACITY,
                           PTQ_ENC_STAGE_VALUES);
      uint32_t l32 = static_cast<uint32_t>(ln);
      raw_buf[raw_pos - 4] = static_cast<uint8_t>(l32);
      raw_buf[raw_pos - 3] = static_cast<uint8_t>(l32 >> 8);
      raw_buf[raw_pos - 2] = static_cast<uint8_t>(l32 >> 16);
      raw_buf[raw_pos - 1] = static_cast<uint8_t>(l32 >> 24);
      raw_pos += static_cast<size_t>(ln);
    } else {  // route 3: DELTA_BINARY_PACKED, one stream per page
      ssize_t ln = ptq_delta_encode(values + vpos * type_size, nn,
                                    type_size * 8, 128, 4,
                                    raw_buf + raw_pos, raw_cap - raw_pos);
      if (ln < 0) ENC_FAIL(ln == -1 ? PTQ_E_CORRUPT : PTQ_E_CAPACITY,
                           PTQ_ENC_STAGE_VALUES);
      raw_pos += static_cast<size_t>(ln);
    }
    clk.stop(EN_VALUES);
    size_t values_raw_len = raw_pos - values_start;

    // -- compress ------------------------------------------------------------
    clk.start();
    ssize_t comp;
    size_t block_len;   // stored block size
    size_t unc_size;    // header's uncompressed_page_size
    if (dpv == 1) {
      comp = compress_block_enc(codec, raw_buf, raw_pos, comp_buf, comp_cap);
      if (comp < 0) ENC_FAIL(comp == -1 ? PTQ_E_CORRUPT : PTQ_E_CAPACITY,
                             PTQ_ENC_STAGE_COMPRESS);
      block_len = static_cast<size_t>(comp);
      unc_size = raw_pos;
    } else {
      // v2: level stream stored RAW ahead of the compressed values block
      comp = compress_block_enc(codec, raw_buf + values_start, values_raw_len,
                                comp_buf, comp_cap);
      if (comp < 0) ENC_FAIL(comp == -1 ? PTQ_E_CORRUPT : PTQ_E_CAPACITY,
                             PTQ_ENC_STAGE_COMPRESS);
      block_len = def_block_len + static_cast<size_t>(comp);
      unc_size = def_block_len + values_raw_len;
    }
    clk.stop(EN_COMPRESS);
    uint32_t crc = 0;
    if (with_crc) {
      if (dpv == 1) {
        crc = static_cast<uint32_t>(
            crc32(0, comp_buf, static_cast<uInt>(comp)));
      } else {
        crc = static_cast<uint32_t>(
            crc32(0, raw_buf, static_cast<uInt>(def_block_len)));
        crc = static_cast<uint32_t>(
            crc32(crc, comp_buf, static_cast<uInt>(comp)));
      }
      clk.stop(EN_CRC);
    }

    // -- frame the PageHeader and copy the block -----------------------------
    if (page_idx >= static_cast<int64_t>(max_pages)) return PTQ_E_PAGES_FULL;
    int encoding =
        route == 2 ? 8 : (route == 3 ? 5 : (route == 4 ? 3 : 0));
    ThriftW w;
    th_init(&w, out, out_cap, pos);
    th_i32(&w, 1, dpv == 1 ? 0 : 3);                 // type
    th_i32(&w, 2, static_cast<int64_t>(unc_size));   // uncompressed size
    th_i32(&w, 3, static_cast<int64_t>(block_len));  // compressed size
    if (with_crc) th_i32(&w, 4, static_cast<int32_t>(crc));
    if (dpv == 1) {
      th_field(&w, 5, 0x0C);  // data_page_header
      w.last_fid = 0;
      th_i32(&w, 1, b - a);   // num_values (level entries)
      th_i32(&w, 2, encoding);
      th_i32(&w, 3, 3);       // definition_level_encoding = RLE
      th_i32(&w, 4, 3);       // repetition_level_encoding = RLE
      th_stop(&w);
      w.last_fid = 5;
    } else {
      th_field(&w, 8, 0x0C);  // data_page_header_v2
      w.last_fid = 0;
      th_i32(&w, 1, b - a);             // num_values
      th_i32(&w, 2, (b - a) - nn);      // num_nulls
      th_i32(&w, 3, b - a);             // num_rows (flat: = entries)
      th_i32(&w, 4, encoding);
      th_i32(&w, 5, static_cast<int64_t>(def_block_len));
      th_i32(&w, 6, 0);                 // repetition_levels_byte_length
      th_bool(&w, 7, true);             // is_compressed
      th_stop(&w);
      w.last_fid = 8;
    }
    th_stop(&w);
    if (!w.ok || w.pos + block_len > out_cap)
      ENC_FAIL(PTQ_E_CAPACITY, PTQ_ENC_STAGE_FRAME);
    size_t hdr_len = w.pos - pos;
    if (dpv == 1) {
      std::memcpy(out + w.pos, comp_buf, block_len);
    } else {
      std::memcpy(out + w.pos, raw_buf, def_block_len);
      std::memcpy(out + w.pos + def_block_len, comp_buf,
                  static_cast<size_t>(comp));
    }
    int64_t* row = pages + page_idx * 8;
    row[0] = static_cast<int64_t>(pos);
    row[1] = static_cast<int64_t>(hdr_len + block_len);
    row[2] = static_cast<int64_t>(hdr_len);
    row[3] = b - a;
    row[4] = nn;
    row[5] = static_cast<int64_t>(unc_size);
    row[6] = 0;
    row[7] = 0;
    pos = w.pos + block_len;
    uncompressed_total +=
        static_cast<int64_t>(hdr_len) + static_cast<int64_t>(unc_size);
    clk.stop(EN_FRAME);
    page_idx++;
    vpos += nn;
    a = b;
  }
  if (max_def == 0 && vpos != nv) ENC_FAIL(PTQ_E_CORRUPT, PTQ_ENC_STAGE_SPLIT);
  totals[0] = static_cast<int64_t>(pos);
  totals[1] = uncompressed_total;
  totals[2] = page_idx;
  totals[3] = dict_off;
  totals[4] = data_off;
  totals[6] = 0;
  totals[7] = 0;
#undef ENC_FAIL
  return static_cast<ssize_t>(page_idx);
}

}  // extern "C"
