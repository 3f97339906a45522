/* The fused chunk encode C ABI of parquet_tpu_torch's host library.
 *
 * A copy of the encode half of the JAX package's native/parquet_tpu_native.h:
 * the ptq_chunk_encode and ptq_gzip_compress prototypes and the
 * PTQ_ENC_STAGE_* stage codes are identical to the original, so the two
 * walks' faults compare field by field; the return codes are prepare.h's
 * PTQ_E_*. The ctypes binding in parquet_tpu_torch/utils/native.py mirrors
 * these signatures; change both together.
 */
#ifndef PARQUET_TPU_TORCH_ENCODE_H
#define PARQUET_TPU_TORCH_ENCODE_H

#include <stddef.h>
#include <stdint.h>
#include <sys/types.h> /* ssize_t */

#ifdef __cplusplus
extern "C" {
#endif

/* ptq_chunk_encode err_info[0] stage codes (the encode walk's phases). */
#define PTQ_ENC_STAGE_SPLIT 1    /* page-split arithmetic / input validation */
#define PTQ_ENC_STAGE_LEVELS 2   /* def-level hybrid pack */
#define PTQ_ENC_STAGE_VALUES 3   /* value-stream encode (plain/dict/delta) */
#define PTQ_ENC_STAGE_COMPRESS 4 /* page block compression */
#define PTQ_ENC_STAGE_FRAME 5    /* Thrift page-header framing / output copy */

/* Fused whole-chunk ENCODE walk: the write-side inverse of
 * ptq_chunk_prepare. One call splits a typed column chunk into pages,
 * packs levels, encodes the value stream (PLAIN numeric/byte-array,
 * RLE_DICTIONARY indices, DELTA_BINARY_PACKED), compresses
 * (UNCOMPRESSED/SNAPPY/GZIP) and frames compact-Thrift page headers —
 * byte-identical to the staged Python encoder in sink/encoder.py.
 *
 * route: 0 PLAIN fixed-width (values = contiguous elements of type_size
 *          bytes), 1 PLAIN byte-array (values = flat data, ba_offsets =
 *          int64[nv+1]), 2 RLE_DICTIONARY (values = uint32 indices,
 *          dict_raw = pre-encoded PLAIN dictionary payload framed as the
 *          leading dictionary page), 3 DELTA_BINARY_PACKED (values =
 *          int32/int64 by type_size), 4 BOOLEAN RLE (values = uint16 0/1,
 *          type_size 2; 4-byte-prefixed width-1 hybrid stream).
 * Returns the DATA page count (>= 0), or: -1 corrupt/unsupported input,
 * -2 page table full (retry larger), -5 out/scratch capacity exceeded
 * (retry larger or fall back). pages is int64[max_pages][8]:
 * {offset, framed size, header len, level entries, non-null count,
 *  raw (uncompressed block) size, 0, 0}. totals[8]: {bytes written,
 * uncompressed total (headers + raw), data page count, dict page offset
 * (-1 when absent), first data page offset, dict page framed size, 0, 0}.
 * stage_ns (nullable int64[5]): levels/values/compress/frame/crc wall ns. */
/* gzip compress with the fused encode walk's exact deflate parameters (the
 * startup byte-identity probe against CPython's zlib). Returns size or -1. */
ssize_t ptq_gzip_compress(const uint8_t* src, size_t src_len, uint8_t* dst,
                          size_t dst_cap);

ssize_t ptq_chunk_encode(
    int route, const uint8_t* values, size_t values_len,
    const int64_t* ba_offsets, int64_t nv, int type_size, int dict_width,
    const uint8_t* dict_raw, size_t dict_raw_len, int64_t dict_num,
    const uint16_t* def_levels, int64_t num_entries, int max_def, int codec,
    int dpv, int with_crc, int64_t per_page, uint8_t* out, size_t out_cap,
    uint8_t* scratch, size_t scratch_cap, int64_t* pages, size_t max_pages,
    int64_t* totals, int64_t* stage_ns, int64_t* err_info);

/* The two prepare.cc encoders the walk calls (snappy blocks, DELTA pages). */
ssize_t ptq_snappy_compress(const char* src_c, size_t src_len, char* dst,
                            size_t dst_cap);
ssize_t ptq_delta_encode(const void* vals, int64_t n, int nbits,
                         int64_t block_size, int64_t mini_count, uint8_t* out,
                         size_t out_cap);

#ifdef __cplusplus
}
#endif

#endif /* PARQUET_TPU_TORCH_ENCODE_H */
