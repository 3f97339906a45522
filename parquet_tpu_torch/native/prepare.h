/* The ptq_chunk_prepare C ABI of parquet_tpu_torch's host library.
 *
 * A copy of the JAX package's native/parquet_tpu_native.h cut down to the
 * prepare walk: the prototype, the PTQ_E_* return codes and the
 * PTQ_STAGE_* stage codes are identical to the original, so the two walks'
 * tables and faults compare field by field. The ctypes binding in
 * parquet_tpu_torch/utils/native.py mirrors this signature; change both
 * together.
 */
#ifndef PARQUET_TPU_TORCH_PREPARE_H
#define PARQUET_TPU_TORCH_PREPARE_H

#include <stddef.h>
#include <stdint.h>
#include <sys/types.h> /* ssize_t */

#ifdef __cplusplus
extern "C" {
#endif

/* Negative return codes of ptq_chunk_prepare. -2/-3/-4 are retryable with
 * bigger tables; -1/-5/-6 abort the walk (err_info carries the detail). */
#define PTQ_E_CORRUPT (-1)    /* corrupt or unsupported input */
#define PTQ_E_PAGES_FULL (-2) /* page table full (retry larger) */
#define PTQ_E_RUNS_FULL (-3)  /* hybrid run table full (retry larger) */
#define PTQ_E_MINIS_FULL (-4) /* delta miniblock table full (retry larger) */
#define PTQ_E_CAPACITY (-5)   /* level/value capacity exceeded */
#define PTQ_E_CRC (-6)        /* stored page CRC mismatch (definite rot) */

/* err_info[0] stage codes: the walk phase that was active when it failed. */
#define PTQ_STAGE_NONE 0
#define PTQ_STAGE_HEADER 1     /* Thrift page-header parse / size checks */
#define PTQ_STAGE_CRC 2        /* stored-CRC verification */
#define PTQ_STAGE_DECOMPRESS 3 /* snappy/gzip/lz4 block decode */
#define PTQ_STAGE_LEVELS 4     /* R/D level hybrid decode */
#define PTQ_STAGE_PRESCAN 5    /* dict-run / delta-miniblock prescan */
#define PTQ_STAGE_VALUES 6     /* value-stream routing / copies */

ssize_t ptq_chunk_prepare(
    const uint8_t* src, size_t src_len, int codec, int validate_crc,
    int max_def, int max_rep, int type_size, int delta_nbits,
    int64_t expected_values, int64_t* pages, size_t max_pages,
    uint16_t* def_out, uint16_t* rep_out, uint8_t* values_out,
    size_t values_cap, uint8_t* packed_out, size_t packed_cap,
    uint8_t* delta_out, size_t delta_cap, uint8_t* scratch, size_t scratch_cap,
    uint8_t* h_is_rle, int64_t* h_counts, uint64_t* h_values,
    int64_t* h_byteoff, size_t max_runs, uint32_t* d_widths,
    int64_t* d_bytestart, int32_t* d_outstart, uint64_t* d_mins,
    size_t max_minis, int64_t* totals, int64_t* stage_ns,
    int64_t* err_info /* nullable [4]: stage, page index, page byte offset in
                         chunk, 0; meaningful only when the return is < 0 */);

#ifdef __cplusplus
}
#endif

#endif /* PARQUET_TPU_TORCH_PREPARE_H */
