"""ctypes binding of the port's host library (parquet_tpu_torch/native/).

A copy of parquet_tpu/utils/native.py cut down to what the port calls: the
whole-chunk walk `chunk_prepare` with its per-thread buffer recycling, the
snappy and LZ4 block codecs, the DELTA_BINARY_PACKED encoder and header
prescan behind the PLAIN->delta transfer repack, the walk's fault report
(`PrepareFault`, `PREPARE_STAGES`, `PREPARE_E_*`), and the host value
functions of native/values.cc and the parsers of native/prepare.cc that the
host read and write paths call: the PLAIN byte-array gather and encode, the
byte-array take, the hybrid prescan, decode and encode, the DELTA decode,
the page-header parser, XXH64 with the bloom filter's batch hashes, inserts
and checks, the byte-array min/max and the dictionary probes; and the write
side of native/encode.cc: the fused whole-chunk encode walk `chunk_encode`
(`EncodeFault`, `ENCODE_STAGES`) and `gzip_compress`. Each method keeps the
original's signature, return convention and error text.

The library is built on first use (kernels/host_build.py); `get_native()`
raises HostBuildError when it cannot be built, so no codec, walk or value
function quietly gives way to a slower one.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import numpy as np

__all__ = [
    "ENCODE_STAGES",
    "EncodeFault",
    "NativeLib",
    "PrepareFault",
    "PREPARE_STAGES",
    "PREPARE_E_CORRUPT",
    "PREPARE_E_CAPACITY",
    "PREPARE_E_CRC",
    "delta_encode_cap",
    "get_native",
    "hybrid_encode_cap",
]

# ptq_chunk_prepare err_info[0] stage codes (native/prepare.h PTQ_STAGE_*).
PREPARE_STAGES = {
    0: "none",
    1: "header",
    2: "crc",
    3: "decompress",
    4: "levels",
    5: "prescan",
    6: "values",
}

# ptq_chunk_prepare terminal return codes (native/prepare.h PTQ_E_*).
PREPARE_E_CORRUPT = -1
PREPARE_E_CAPACITY = -5
PREPARE_E_CRC = -6

# ptq_chunk_encode err_info[0] stage codes (native/encode.h PTQ_ENC_STAGE_*).
ENCODE_STAGES = {
    0: "none",
    1: "split",
    2: "levels",
    3: "values",
    4: "compress",
    5: "frame",
}


def hybrid_encode_cap(n: int, width: int) -> int:
    """Worst-case hybrid RLE/bit-pack stream size for n values at `width`
    bits: the one sizing formula behind hybrid_encode's output buffer and
    the fused encode walk's capacity planning."""
    vbytes = (width + 7) // 8
    return 64 + (n // 8 + 2) * (5 + vbytes) + ((n + 7) // 8) * max(width, 1)


def delta_encode_cap(
    n: int, nbits: int, block_size: int = 128, mini_count: int = 4
) -> int:
    """Worst-case DELTA_BINARY_PACKED size: header + per-block zigzag +
    widths + payloads at full width (delta_encode's buffer and the fused
    encode walk's capacity planning)."""
    blocks = max(n // block_size + 2, 1)
    return (
        64
        + blocks * (10 + mini_count)
        + ((n + block_size) * nbits) // 8
        + block_size
    )


class EncodeFault(NamedTuple):
    """Structured failure report from the fused native chunk encode: the
    negative return code plus the stage/page context. NOT an exception:
    encode_chunk's fallback ladder retries the chunk on the staged Python
    encoder, which raises the exact typed error if the input is genuinely
    unencodable."""

    code: int
    stage: str
    page: int


class PrepareFault(NamedTuple):
    """Structured failure report from the fused native chunk walk: the
    negative return code (PREPARE_E_*) plus the stage/page/byte-offset
    context the walk recorded when it aborted. NOT an exception: the
    pipeline's fallback ladder retries the chunk on the staged Python walk,
    which raises the exact typed error if the input is genuinely corrupt."""

    code: int
    stage: str
    page: int
    offset: int


def _ptr(data):
    """(address, length, keepalive) for any contiguous readable buffer,
    without the `bytes(data)` copy a c_char_p signature would force."""
    if isinstance(data, bytes):
        # ctypes converts bytes to a char pointer for c_void_p params directly
        return data, len(data), data
    arr = np.frombuffer(data, dtype=np.uint8)
    return arr.ctypes.data, arr.size, arr


_P = ctypes.c_void_p
_SZ = ctypes.c_size_t
_SSZ = ctypes.c_ssize_t
_I = ctypes.c_int
_I64 = ctypes.c_int64
_U64 = ctypes.c_uint64


class NativeLib:
    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        self._chunk_tl = threading.local()  # per-thread chunk_prepare scratch
        lib.ptq_snappy_max_compressed_length.restype = _SZ
        lib.ptq_snappy_max_compressed_length.argtypes = [_SZ]
        lib.ptq_lz4_max_compressed_length.restype = _SZ
        lib.ptq_lz4_max_compressed_length.argtypes = [_SZ]
        for fn in (
            lib.ptq_snappy_compress,
            lib.ptq_snappy_decompress,
            lib.ptq_lz4_compress,
            lib.ptq_lz4_decompress,
            lib.ptq_lz4_hadoop_decompress,
        ):
            fn.restype = _SSZ
            fn.argtypes = [_P, _SZ, _P, _SZ]
        lib.ptq_lz4_decompress_into.restype = _SSZ
        lib.ptq_lz4_decompress_into.argtypes = [_P, _SZ, _P, _SZ, _SZ]
        lib.ptq_delta_encode.restype = _SSZ
        lib.ptq_delta_encode.argtypes = [_P, _I64, _I, _I64, _I64, _P, _SZ]
        lib.ptq_prescan_delta_packed.restype = _SSZ
        lib.ptq_prescan_delta_packed.argtypes = [
            _P, _SZ, _I, _I64, _P, _P, _P, _P, _SZ, _P, _P, _P,
        ]
        # the host value functions (native/values.cc) and the two parsers of
        # native/prepare.cc the host paths call
        lib.ptq_xxh64.restype = _U64
        lib.ptq_xxh64.argtypes = [_P, _SZ, _U64]
        lib.ptq_xxh64_fixed.restype = _SSZ
        lib.ptq_xxh64_fixed.argtypes = [_P, _I64, _I, _P]
        lib.ptq_xxh64_offsets.restype = _SSZ
        lib.ptq_xxh64_offsets.argtypes = [_P, _P, _I64, _P]
        lib.ptq_bloom_insert.restype = _SSZ
        lib.ptq_bloom_insert.argtypes = [_P, _I64, _P, _I64]
        lib.ptq_bloom_check.restype = _SSZ
        lib.ptq_bloom_check.argtypes = [_P, _I64, _P, _I64, _P]
        lib.ptq_byte_array_gather.restype = _SSZ
        lib.ptq_byte_array_gather.argtypes = [_P, _SZ, _I64, _P, _P, _SZ]
        lib.ptq_hybrid_decode.restype = _SSZ
        lib.ptq_hybrid_decode.argtypes = [_P, _SZ, _I64, _I, _P, _P]
        lib.ptq_delta_decode.restype = _SSZ
        lib.ptq_delta_decode.argtypes = [_P, _SZ, _I, _I64, _P, _P]
        lib.ptq_delta_peek_total.restype = _SSZ
        lib.ptq_delta_peek_total.argtypes = [_P, _SZ, _P]
        lib.ptq_bytearray_take.restype = _SSZ
        lib.ptq_bytearray_take.argtypes = [_P, _SZ, _P, _I64, _P, _I64, _P, _P, _SZ]
        lib.ptq_plain_encode_bytearray.restype = _SSZ
        lib.ptq_plain_encode_bytearray.argtypes = [_P, _SZ, _P, _I64, _P, _SZ]
        lib.ptq_parse_page_header.restype = _SSZ
        lib.ptq_parse_page_header.argtypes = [_P, _SZ, _P]
        lib.ptq_prescan_hybrid.restype = _SSZ
        lib.ptq_prescan_hybrid.argtypes = [_P, _SZ, _I64, _I, _P, _P, _P, _P, _SZ, _P]
        lib.ptq_hybrid_encode.restype = _SSZ
        lib.ptq_hybrid_encode.argtypes = [_P, _I64, _I, _P, _SZ]
        lib.ptq_bytes_dict_indices.restype = _SSZ
        lib.ptq_bytes_dict_indices.argtypes = [_P, _SZ, _P, _I64, _I64, _P, _P]
        lib.ptq_bytes_minmax.restype = _SSZ
        lib.ptq_bytes_minmax.argtypes = [_P, _SZ, _P, _I64, _P]
        lib.ptq_u64_dict_indices.restype = _SSZ
        lib.ptq_u64_dict_indices.argtypes = [_P, _I, _I64, _I64, _P, _P]
        lib.ptq_chunk_prepare.restype = _SSZ
        lib.ptq_chunk_prepare.argtypes = (
            [_P, _SZ]  # src
            # codec, validate_crc, max_def, max_rep, type_size, delta_nbits
            + [_I] * 6
            + [_I64]  # expected_values
            + [_P, _SZ]  # pages
            + [_P, _P]  # def_out, rep_out
            + [_P, _SZ] * 4  # values/packed/delta/scratch
            + [_P] * 4 + [_SZ]  # hybrid tables
            + [_P] * 4 + [_SZ]  # delta tables
            + [_P]  # totals
            + [_P]  # stage_ns (nullable per-stage clock)
            + [_P]  # err_info (nullable int64[4])
        )
        # the write side (native/encode.cc)
        lib.ptq_gzip_compress.restype = _SSZ
        lib.ptq_gzip_compress.argtypes = [_P, _SZ, _P, _SZ]
        lib.ptq_chunk_encode.restype = _SSZ
        lib.ptq_chunk_encode.argtypes = (
            [_I]  # route
            + [_P, _SZ]  # values
            + [_P, _I64]  # ba_offsets, nv
            + [_I, _I]  # type_size, dict_width
            + [_P, _SZ, _I64]  # dict_raw, dict_raw_len, dict_num
            + [_P, _I64, _I]  # def_levels, num_entries, max_def
            + [_I, _I, _I]  # codec, dpv, with_crc
            + [_I64]  # per_page
            + [_P, _SZ]  # out
            + [_P, _SZ]  # scratch
            + [_P, _SZ]  # pages, max_pages
            + [_P, _P, _P]  # totals, stage_ns, err_info
        )

    # -- block codecs ----------------------------------------------------------

    def snappy_compress(self, data) -> bytes:
        addr, n_in, _keep = _ptr(data)
        cap = self._lib.ptq_snappy_max_compressed_length(n_in)
        out = ctypes.create_string_buffer(cap)
        n = self._lib.ptq_snappy_compress(addr, n_in, out, cap)
        if n < 0:
            raise ValueError("native snappy: compression failed")
        return out.raw[:n]

    def snappy_decompress(self, data, uncompressed_size: int):
        """A memoryview over a freshly decoded buffer (no memset, no trailing
        copy)."""
        addr, n_in, _keep = _ptr(data)
        # 64 bytes of slack past the logical size switches the decoder into
        # its overshooting-wide-copy fast mode; the view below hides it
        out = np.empty(max(uncompressed_size, 1) + 64, dtype=np.uint8)
        n = self._lib.ptq_snappy_decompress(
            addr, n_in, ctypes.c_void_p(out.ctypes.data), uncompressed_size + 64
        )
        # n > uncompressed_size: the stream's own length claim exceeded the
        # page header's: corrupt
        if n < 0 or n > uncompressed_size:
            raise ValueError("native snappy: corrupt input")
        return memoryview(out)[:n]

    def lz4_compress(self, data) -> bytes:
        """One raw LZ4 block (no framing, no size prefix)."""
        addr, n_in, _keep = _ptr(data)
        cap = self._lib.ptq_lz4_max_compressed_length(n_in)
        out = ctypes.create_string_buffer(cap)
        n = self._lib.ptq_lz4_compress(addr, n_in, out, cap)
        if n < 0:
            raise ValueError("native lz4: compression failed")
        return out.raw[:n]

    def lz4_decompress(self, data, uncompressed_size: int, hadoop: bool = False):
        """Decode one raw LZ4 block; hadoop=True also accepts the Hadoop
        [BE usize][BE csize] framing parquet's legacy LZ4 codec uses."""
        addr, n_in, _keep = _ptr(data)
        out = np.empty(max(uncompressed_size, 1), dtype=np.uint8)
        fn = (
            self._lib.ptq_lz4_hadoop_decompress
            if hadoop
            else self._lib.ptq_lz4_decompress
        )
        n = fn(addr, n_in, ctypes.c_void_p(out.ctypes.data), uncompressed_size)
        if n < 0:
            raise ValueError("native lz4: corrupt input")
        return memoryview(out)[:n]

    def lz4_decompress_into(self, data, out: np.ndarray, start: int, cap: int) -> int:
        """Decode one raw LZ4 block into `out` (uint8) from `start` on, no
        write past `cap`; a match may reach back into out[:start] (the
        earlier blocks of a linked LZ4 frame). Returns the end position,
        or -1 for a corrupt block."""
        if len(out) < cap:
            raise ValueError("native lz4: output shorter than its cap")
        addr, n_in, _keep = _ptr(data)
        return self._lib.ptq_lz4_decompress_into(
            addr, n_in, ctypes.c_void_p(out.ctypes.data), start, cap
        )

    # -- DELTA_BINARY_PACKED (the transfer repack) -----------------------------

    def delta_encode(self, values, nbits: int, block_size: int, mini_count: int) -> bytes:
        """DELTA_BINARY_PACKED encode (byte-identical to ops/delta.py
        encode_delta)."""
        dt = np.int32 if nbits == 32 else np.int64
        v = np.ascontiguousarray(values, dtype=dt)
        n = len(v)
        cap = delta_encode_cap(n, nbits, block_size, mini_count)
        out = np.empty(cap, dtype=np.uint8)
        rc = self._lib.ptq_delta_encode(
            ctypes.c_void_p(v.ctypes.data), n, nbits, block_size, mini_count,
            ctypes.c_void_p(out.ctypes.data), cap,
        )
        if rc < 0:
            raise ValueError("native: delta encode failed")
        return out[: int(rc)].tobytes()

    def prescan_delta_packed(self, data: bytes, nbits: int, max_total: int):
        """Header-only delta prescan. Returns (widths, byte_starts, out_starts,
        mins, first_value, total, consumed). Raises OverflowError when the
        stream's count exceeds max_total."""
        max_total = max(max_total, 0)
        # one entry per miniblock with >= 1 real delta, each of which also
        # consumes at least its width byte: a lying header cannot drive the
        # allocation past the stream's length
        addr, n_in, _keep = _ptr(data)
        max_entries = min(max(max_total, 8) // 8 + 2, n_in + 2)
        widths = np.empty(max_entries, dtype=np.uint32)
        byte_starts = np.empty(max_entries, dtype=np.int64)
        out_starts = np.empty(max_entries, dtype=np.int32)
        mins = np.empty(max_entries, dtype=np.uint64)
        first = np.zeros(1, dtype=np.uint64)
        total = np.zeros(1, dtype=np.int64)
        consumed = np.zeros(1, dtype=np.int64)
        m = self._lib.ptq_prescan_delta_packed(
            addr, n_in, nbits, max_total,
            widths.ctypes.data_as(_P), byte_starts.ctypes.data_as(_P),
            out_starts.ctypes.data_as(_P), mins.ctypes.data_as(_P), max_entries,
            first.ctypes.data_as(_P), total.ctypes.data_as(_P),
            consumed.ctypes.data_as(_P),
        )
        if m == -3:
            raise OverflowError(
                f"stream claims more than the caller's bound of {max_total} values"
            )
        if m < 0:
            raise ValueError("native: corrupt delta stream")
        m = int(m)
        return (
            widths[:m],
            byte_starts[:m],
            out_starts[:m],
            mins[:m],
            int(first[0]),
            int(total[0]),
            int(consumed[0]),
        )

    # -- host value functions (native/values.cc) -------------------------------

    def xxh64(self, data, seed: int = 0) -> int:
        addr, n, _keep = _ptr(data)
        return int(self._lib.ptq_xxh64(addr, n, seed))

    def xxh64_fixed(self, data, n: int, stride: int):
        """XXH64 of n contiguous `stride`-byte elements -> uint64[n]."""
        addr, n_in, _keep = _ptr(data)
        if n < 0 or stride < 0 or n * stride > n_in:
            raise ValueError("native: xxh64_fixed elements exceed the buffer")
        out = np.empty(n, dtype=np.uint64)
        if self._lib.ptq_xxh64_fixed(addr, n, stride, ctypes.c_void_p(out.ctypes.data)) < 0:
            raise ValueError("native: xxh64_fixed failed")
        return out

    def xxh64_offsets(self, data, offsets):
        """XXH64 of each (offsets, data) byte-array value -> uint64[n]."""
        n = len(offsets) - 1
        addr, _nb, _keep = _ptr(data)
        off = np.ascontiguousarray(offsets, dtype=np.int64)
        out = np.empty(max(n, 0), dtype=np.uint64)
        rc = self._lib.ptq_xxh64_offsets(
            addr, ctypes.c_void_p(off.ctypes.data), n, ctypes.c_void_p(out.ctypes.data),
        )
        if rc < 0:
            raise ValueError("native: xxh64_offsets failed")
        return out

    def bloom_insert(self, blocks, hashes) -> None:
        h = np.ascontiguousarray(hashes, dtype=np.uint64)
        if self._lib.ptq_bloom_insert(
            ctypes.c_void_p(blocks.ctypes.data), len(blocks) // 8,
            ctypes.c_void_p(h.ctypes.data), len(h),
        ) < 0:
            raise ValueError("native: bloom insert into an empty bitset")

    def bloom_check(self, blocks, hashes):
        """Per hash: might it be present (bool[n])."""
        h = np.ascontiguousarray(hashes, dtype=np.uint64)
        out = np.empty(len(h), dtype=np.uint8)
        if self._lib.ptq_bloom_check(
            ctypes.c_void_p(blocks.ctypes.data), len(blocks) // 8,
            ctypes.c_void_p(h.ctypes.data), len(h), ctypes.c_void_p(out.ctypes.data),
        ) < 0:
            raise ValueError("native: bloom check against an empty bitset")
        return out.astype(bool)

    def byte_array_gather(self, data, num_values: int):
        """PLAIN byte_array scan: returns (offsets int64[n+1], flat bytes, consumed)."""
        addr, n_in, _keep = _ptr(data)
        offsets = np.empty(num_values + 1, dtype=np.int64)
        out = ctypes.create_string_buffer(max(n_in, 1))
        consumed = self._lib.ptq_byte_array_gather(
            addr, n_in, num_values, offsets.ctypes.data_as(_P), out, n_in,
        )
        if consumed < 0:
            raise ValueError("native: corrupt byte_array stream")
        # single copy of exactly the payload (out.raw would copy the whole cap)
        flat = ctypes.string_at(out, int(offsets[-1]))
        return offsets, flat, int(consumed)

    def hybrid_decode(self, data, num_values: int, width: int, nbits: int):
        """One-shot hybrid RLE/bit-pack decode. Returns (values, consumed);
        values is uint32 (nbits==32) or uint64 (nbits==64)."""
        addr, n_in, _keep = _ptr(data)
        out = np.empty(num_values, dtype=np.uint32 if nbits == 32 else np.uint64)
        p = out.ctypes.data_as(_P)
        consumed = self._lib.ptq_hybrid_decode(
            addr, n_in, num_values, width,
            p if nbits == 32 else None,
            p if nbits == 64 else None,
        )
        if consumed < 0:
            raise ValueError("native: corrupt hybrid stream")
        return out, int(consumed)

    def delta_decode(self, data, nbits: int, max_total: int | None):
        """Full DELTA_BINARY_PACKED decode. Returns (int32/int64 values, consumed).
        Raises OverflowError when the stream's count exceeds max_total."""
        addr, n_in, _keep = _ptr(data)
        total = np.zeros(1, dtype=np.int64)
        if self._lib.ptq_delta_peek_total(addr, n_in, total.ctypes.data_as(_P)) < 0:
            raise ValueError("native: corrupt delta header")
        cap = int(total[0])
        if max_total is not None and cap > max(max_total, 0):
            raise OverflowError(
                f"stream claims {cap} values, caller expects at most {max_total}"
            )
        out = np.empty(cap, dtype=np.int32 if nbits == 32 else np.int64)
        # max_total already enforced above on the peeked count; the C-side
        # bound (-3) is unreachable from here, so pass "no bound"
        consumed = self._lib.ptq_delta_decode(
            addr, n_in, nbits, -1, out.ctypes.data_as(_P), total.ctypes.data_as(_P),
        )
        if consumed < 0:
            raise ValueError("native: corrupt delta stream")
        return out, int(consumed)

    def plain_encode_bytearray(self, data, offsets) -> bytes:
        """(offsets, data) column -> PLAIN stream ([4B LE len][bytes] per
        value) in one C pass."""
        offsets = np.ascontiguousarray(offsets, dtype=np.int64)
        n = len(offsets) - 1
        addr, n_in, _keep = _ptr(data)
        cap = n_in + 4 * max(n, 0)
        out = np.empty(max(cap, 1), dtype=np.uint8)
        rc = self._lib.ptq_plain_encode_bytearray(
            addr, n_in, offsets.ctypes.data_as(_P), n, ctypes.c_void_p(out.ctypes.data), cap,
        )
        if rc < 0:
            raise ValueError("native: corrupt byte-array offsets")
        return out[: int(rc)].tobytes()

    def bytearray_take(self, data: bytes, offsets, indices, new_offsets, total: int) -> bytes:
        """Gather rows of an (offsets, data) byte-array column by index."""
        offsets = np.ascontiguousarray(offsets, dtype=np.int64)
        indices = np.ascontiguousarray(indices, dtype=np.int64)
        new_offsets = np.ascontiguousarray(new_offsets, dtype=np.int64)
        addr, n_in, _keep = _ptr(data)
        out = ctypes.create_string_buffer(max(total, 1))
        rc = self._lib.ptq_bytearray_take(
            addr, n_in,
            offsets.ctypes.data_as(_P), len(offsets) - 1,
            indices.ctypes.data_as(_P), len(indices),
            new_offsets.ctypes.data_as(_P), out, total,
        )
        if rc < 0:
            raise ValueError("native: byte-array take index out of range")
        return ctypes.string_at(out, total)

    def prescan_hybrid(self, data, num_values: int, width: int):
        """Run-header prescan: returns (is_rle, counts, values, bp_offsets, consumed)
        with bp_offsets absolute into `data`."""
        addr, n_in, _keep = _ptr(data)
        max_runs = 4096
        while True:
            is_rle = np.empty(max_runs, dtype=np.uint8)
            counts = np.empty(max_runs, dtype=np.int64)
            values = np.empty(max_runs, dtype=np.uint64)
            offsets = np.empty(max_runs, dtype=np.int64)
            consumed = np.zeros(1, dtype=np.int64)
            n = self._lib.ptq_prescan_hybrid(
                addr, n_in, num_values, width,
                is_rle.ctypes.data_as(_P), counts.ctypes.data_as(_P),
                values.ctypes.data_as(_P), offsets.ctypes.data_as(_P),
                max_runs, consumed.ctypes.data_as(_P),
            )
            if n == -2:
                max_runs *= 8
                continue
            if n < 0:
                raise ValueError("native: corrupt hybrid stream")
            n = int(n)
            return (
                is_rle[:n].astype(bool),
                counts[:n],
                values[:n],
                offsets[:n],
                int(consumed[0]),
            )

    def hybrid_encode(self, values, width: int) -> bytes:
        """RLE/bit-pack hybrid encode of a uint64 array (byte-identical to
        ops/rle_hybrid.py encode_hybrid_plain)."""
        v = np.ascontiguousarray(values, dtype=np.uint64)
        n = len(v)
        cap = hybrid_encode_cap(n, width)
        out = np.empty(cap, dtype=np.uint8)
        rc = self._lib.ptq_hybrid_encode(
            ctypes.c_void_p(v.ctypes.data), n, width, ctypes.c_void_p(out.ctypes.data), cap,
        )
        if rc < 0:
            raise ValueError(
                f"native: hybrid encode failed ({'value too wide' if rc == -1 else 'capacity'})"
            )
        return out[: int(rc)].tobytes()

    def bytes_dict_indices(self, data, offsets, max_uniques: int):
        """Dictionary probe over an (offsets, data) byte-array column.
        Returns (first_occurrence_rows uint32[U], indices uint32[n]) or None
        when uniques exceed max_uniques."""
        offsets = np.ascontiguousarray(offsets, dtype=np.int64)
        n = len(offsets) - 1
        addr, data_len, _keep = _ptr(data)
        indices = np.empty(max(n, 1), dtype=np.uint32)
        firsts = np.empty(max_uniques + 2, dtype=np.uint32)
        rc = self._lib.ptq_bytes_dict_indices(
            addr, data_len, ctypes.c_void_p(offsets.ctypes.data), n, max_uniques,
            ctypes.c_void_p(indices.ctypes.data), ctypes.c_void_p(firsts.ctypes.data),
        )
        if rc == -2:
            return None
        if rc < 0:
            raise ValueError("native: byte-array dictionary probe failed")
        return firsts[: int(rc)], indices[:n]

    def bytes_minmax(self, data, offsets):
        """(row of lexicographic min, row of max) over a byte-array column."""
        offsets = np.ascontiguousarray(offsets, dtype=np.int64)
        n = len(offsets) - 1
        addr, data_len, _keep = _ptr(data)
        out = np.empty(2, dtype=np.int64)
        rc = self._lib.ptq_bytes_minmax(
            addr, data_len, ctypes.c_void_p(offsets.ctypes.data), n,
            ctypes.c_void_p(out.ctypes.data),
        )
        if rc < 0:
            raise ValueError("native: byte-array minmax failed")
        return int(out[0]), int(out[1])

    def u64_dict_indices(self, bits, max_uniques: int):
        """Dictionary probe over uint32/uint64 bit patterns (probed in place,
        no widening copy); early-exits past the unique cutoff. Returns
        (first_rows, indices) or None over the cap."""
        v = np.ascontiguousarray(bits)
        if v.dtype not in (np.dtype(np.uint32), np.dtype(np.uint64)):
            v = v.astype(np.uint64)
        n = len(v)
        indices = np.empty(max(n, 1), dtype=np.uint32)
        firsts = np.empty(max_uniques + 2, dtype=np.uint32)
        rc = self._lib.ptq_u64_dict_indices(
            ctypes.c_void_p(v.ctypes.data), v.dtype.itemsize, n, max_uniques,
            ctypes.c_void_p(indices.ctypes.data), ctypes.c_void_p(firsts.ctypes.data),
        )
        if rc == -2:
            return None
        if rc < 0:
            raise ValueError("native: u64 dictionary probe failed")
        return firsts[: int(rc)], indices[:n]

    def parse_page_header(self, window: bytes):
        """Parse one Thrift compact PageHeader from a peeked window.

        Returns the 23-slot int64 array (see ptq_parse_page_header layout),
        None when the window was too small (caller re-peeks larger), or
        raises ValueError on structurally corrupt bytes (caller falls back
        to the Python reader for its exact error)."""
        addr, n_in, _keep = _ptr(window)
        out = np.empty(23, dtype=np.int64)
        rc = self._lib.ptq_parse_page_header(addr, n_in, out.ctypes.data_as(_P))
        if rc == -2:
            return None
        if rc < 0:
            raise ValueError("native: corrupt page header")
        return out

    # -- the whole-chunk prepare walk ------------------------------------------

    _POOL_MAX_BUFS = 6
    _POOL_MAX_BYTES = 64 << 20  # don't hold giant one-off chunks
    _POOL_MAX_TOTAL = 192 << 20  # per-thread retention cap (all buffers)

    def _take_buf(self, size: int):
        """A uint8 staging buffer from the per-thread pool (best fit), or a
        fresh np.empty. Pooled buffers have their pages already faulted in,
        which is most of the cost of writing a fresh multi-MB allocation.
        Entries more than 4x the request are left for larger chunks."""
        pool = getattr(self._chunk_tl, "out_pool", None)
        if pool:
            best = -1
            for k in range(len(pool)):
                n = len(pool[k])
                if size <= n <= max(4 * size, 1 << 16) and (
                    best < 0 or n < len(pool[best])
                ):
                    best = k
            if best >= 0:
                return pool.pop(best)
        return np.empty(size, dtype=np.uint8)

    def release_buffers(self, res: dict, names) -> None:
        """Hand chunk_prepare staging buffers back to this thread's pool.

        ONLY legal when the caller proves no view of the named buffers
        escapes into the returned plan: then no upload reads them either
        (kernels/pipeline.to_device copies its pageable source into pinned
        staging before it returns; the asynchronous copy reads only that
        staging block, which torch's caching host allocator reuses once the
        copy's event has completed). Must run on the thread that called
        chunk_prepare."""
        bases = res.get("_bases")
        if not bases:
            return
        tl = self._chunk_tl
        pool = getattr(tl, "out_pool", None)
        if pool is None:
            pool = tl.out_pool = []
        held = sum(len(b) for b in pool)
        for name in names:
            buf = bases.pop(name, None)
            if (
                buf is not None
                and len(buf)
                and len(buf) <= self._POOL_MAX_BYTES
                and len(pool) < self._POOL_MAX_BUFS
                and held + len(buf) <= self._POOL_MAX_TOTAL
            ):
                pool.append(buf)
                held += len(buf)

    def chunk_prepare(
        self,
        data,
        codec: int,
        max_def: int,
        max_rep: int,
        type_size: int,
        delta_nbits: int,
        expected_values: int,
        uncompressed_cap: int,
        collect_stages: bool = False,
        validate_crc: bool = False,
    ):
        """Whole-chunk prepare walk (ptq_chunk_prepare): one native call does
        header parse + (opt-in) CRC verify + decompress + level decode +
        value-stream prescan for every page, with the GIL dropped at the
        ctypes boundary. Returns a dict of packed tables on success, or a
        PrepareFault naming the failing {code, stage, page, offset} when the
        chunk needs the Python walk. collect_stages=True adds a "stage_ns"
        int64[5] entry (decompress, levels, prescan, copy, crc wall ns)."""
        addr, n_in, _keep = _ptr(data)
        cap = max(uncompressed_cap, n_in) + 64
        lv = max(expected_values, 1)
        max_pages, max_runs, max_minis = 1024, 4096, 4096
        def_out = np.empty(lv, dtype=np.uint16) if max_def > 0 else np.empty(0, np.uint16)
        rep_out = np.empty(lv, dtype=np.uint16) if max_rep > 0 else np.empty(0, np.uint16)
        values_out = self._take_buf(cap)
        packed_out = self._take_buf(cap)
        # delta_out slack covers the worst-case PLAIN->delta repack
        delta_out = (
            self._take_buf(cap + cap // 64 + 4096)
            if delta_nbits
            else np.empty(0, np.uint8)
        )
        # the decompress scratch never escapes the C call: pooled per thread.
        # +64 bytes of slack switches snappy into its overshooting fast mode
        tl = self._chunk_tl
        scratch = getattr(tl, "scratch", None)
        if scratch is None or len(scratch) < cap + 64:
            scratch = tl.scratch = np.empty(cap + 64, dtype=np.uint8)
        totals = np.zeros(8, dtype=np.int64)
        stage_ns = np.zeros(5, dtype=np.int64) if collect_stages else None
        err_info = np.zeros(4, dtype=np.int64)
        p = _P
        while True:
            if stage_ns is not None:
                stage_ns[:] = 0  # a table-growth retry re-walks from scratch
            pages = np.empty((max_pages, 18), dtype=np.int64)
            h_is_rle = np.empty(max_runs, dtype=np.uint8)
            h_counts = np.empty(max_runs, dtype=np.int64)
            h_values = np.empty(max_runs, dtype=np.uint64)
            h_byteoff = np.empty(max_runs, dtype=np.int64)
            d_widths = np.empty(max_minis, dtype=np.uint32)
            d_bytestart = np.empty(max_minis, dtype=np.int64)
            d_outstart = np.empty(max_minis, dtype=np.int32)
            d_mins = np.empty(max_minis, dtype=np.uint64)
            rc = self._lib.ptq_chunk_prepare(
                addr, n_in, codec, 1 if validate_crc else 0,
                max_def, max_rep, type_size, delta_nbits,
                expected_values,
                pages.ctypes.data_as(p), max_pages,
                def_out.ctypes.data_as(p), rep_out.ctypes.data_as(p),
                values_out.ctypes.data_as(p), cap,
                packed_out.ctypes.data_as(p), cap,
                delta_out.ctypes.data_as(p), len(delta_out),
                scratch.ctypes.data_as(p), len(scratch),
                h_is_rle.ctypes.data_as(p), h_counts.ctypes.data_as(p),
                h_values.ctypes.data_as(p), h_byteoff.ctypes.data_as(p), max_runs,
                d_widths.ctypes.data_as(p), d_bytestart.ctypes.data_as(p),
                d_outstart.ctypes.data_as(p), d_mins.ctypes.data_as(p), max_minis,
                totals.ctypes.data_as(p),
                None if stage_ns is None else stage_ns.ctypes.data_as(p),
                err_info.ctypes.data_as(p),
            )
            if rc == -2 and max_pages < (1 << 24):
                max_pages *= 8
                continue
            if rc == -3 and max_runs < n_in + 8:
                max_runs = min(max_runs * 8, n_in + 8)
                continue
            if rc == -4 and max_minis < n_in + 8:
                max_minis = min(max_minis * 8, n_in + 8)
                continue
            if rc < 0:
                return PrepareFault(
                    code=int(rc),
                    stage=PREPARE_STAGES.get(int(err_info[0]), "none"),
                    page=int(err_info[1]),
                    offset=int(err_info[2]),
                )
            n = int(rc)
            R = int(totals[4])
            M = int(totals[5])
            return {
                "pages": pages[:n],
                "def": def_out[: int(totals[0])] if max_def > 0 else None,
                "rep": rep_out[: int(totals[0])] if max_rep > 0 else None,
                "values": values_out[: int(totals[1])],
                "packed": packed_out[: int(totals[2])],
                "delta_stream": delta_out[: int(totals[3])],
                "_bases": {
                    "values": values_out,
                    "packed": packed_out,
                    "delta": delta_out if delta_nbits else None,
                },
                "h_is_rle": h_is_rle[:R],
                "h_counts": h_counts[:R],
                "h_values": h_values[:R],
                "h_byteoff": h_byteoff[:R],
                "d_widths": d_widths[:M],
                "d_bytestart": d_bytestart[:M],
                "d_outstart": d_outstart[:M],
                "d_mins": d_mins[:M],
                "has_dict": bool(totals[6]),
                "stage_ns": stage_ns,
            }


    # -- the fused whole-chunk encode walk (native/encode.cc) ------------------

    def gzip_compress(self, data) -> bytes:
        """Deflate with the fused encode walk's exact gzip parameters (the
        one-time identity probe against CPython's zlib)."""
        addr, n_in, _keep = _ptr(data)
        cap = n_in + n_in // 4 + 128
        out = ctypes.create_string_buffer(cap)
        n = self._lib.ptq_gzip_compress(addr, n_in, out, cap)
        if n < 0:
            raise ValueError("native gzip: compression failed")
        return out.raw[:n]

    def chunk_encode(
        self,
        route: int,
        values,
        ba_offsets,
        nv: int,
        type_size: int,
        dict_width: int,
        dict_raw,
        dict_num: int,
        def_levels,
        num_entries: int,
        max_def: int,
        codec: int,
        dpv: int,
        with_crc: bool,
        per_page: int,
        raw_worst: int,
        collect_stages: bool = False,
    ):
        """Whole-chunk encode walk (ptq_chunk_encode): one native call does
        page split + level pack + value encode + compress + Thrift page
        framing, with the GIL dropped at the ctypes boundary. Returns a dict
        {out, pages, totals, stage_ns} on success (`out` is a uint8 view of
        exactly the framed chunk bytes), or an EncodeFault naming the failing
        {code, stage, page} when the chunk needs the staged Python encoder.
        `raw_worst` is the caller's worst-case raw (uncompressed) page-block
        bound; the output and scratch capacities derive from it with
        compression-expansion slack, and a -5 capacity verdict retries with
        doubled buffers twice before reporting the fault."""
        # worst case for an incompressible block: snappy adds ~n/6 + 32,
        # deflate ~n/1000 + 13: one shared slack covers every codec
        comp_slack = raw_worst // 4 + 1024
        scratch_cap = 2 * (raw_worst + comp_slack)
        out_cap = (
            raw_worst
            + comp_slack
            + int(dict_raw.nbytes if hasattr(dict_raw, "nbytes") else len(dict_raw or b""))
            + 4096
        )
        max_pages = int(num_entries // max(per_page, 1)) + 3
        totals = np.zeros(8, dtype=np.int64)
        stage_ns = np.zeros(5, dtype=np.int64) if collect_stages else None
        err_info = np.zeros(4, dtype=np.int64)
        p = _P
        attempts = 0
        va, v_len, _vk = _ptr(values)
        oa = da = fa = None
        ok = dk = fk = None
        d_len = 0
        if ba_offsets is not None:
            oa, _n, ok = _ptr(ba_offsets)
        if dict_raw is not None:
            da, d_len, dk = _ptr(dict_raw)
        if def_levels is not None:
            fa, _n, fk = _ptr(def_levels)
        while True:
            out = np.empty(out_cap, dtype=np.uint8)
            scratch = self._take_buf(scratch_cap)
            pages = np.empty((max_pages, 8), dtype=np.int64)
            if stage_ns is not None:
                stage_ns[:] = 0
            rc = self._lib.ptq_chunk_encode(
                route, va, v_len, oa, nv, type_size, dict_width,
                da, d_len, dict_num, fa, num_entries, max_def,
                codec, dpv, 1 if with_crc else 0, per_page,
                ctypes.c_void_p(out.ctypes.data), out_cap,
                ctypes.c_void_p(scratch.ctypes.data), scratch_cap,
                pages.ctypes.data_as(p), max_pages,
                totals.ctypes.data_as(p),
                None if stage_ns is None else stage_ns.ctypes.data_as(p),
                err_info.ctypes.data_as(p),
            )
            # scratch never escapes the walk: always pool it back
            self.release_buffers({"_bases": {"scratch": scratch}}, ("scratch",))
            if rc == -2 and max_pages < (1 << 24):
                max_pages *= 8
                continue
            if rc == -5 and attempts < 2:
                attempts += 1
                out_cap *= 2
                scratch_cap *= 2
                continue
            del ok, dk, fk  # keepalives live through the calls
            if rc < 0:
                return EncodeFault(
                    code=int(rc),
                    stage=ENCODE_STAGES.get(int(err_info[0]), "none"),
                    page=int(err_info[1]),
                )
            return {
                "out": out[: int(totals[0])],
                "pages": pages[: int(rc)],
                "totals": totals,
                "stage_ns": stage_ns,
            }


_cached: NativeLib | None = None
_cached_lock = threading.Lock()


def get_native() -> NativeLib:
    """The port's host library, built on first use. Raises
    kernels.host_build.HostBuildError when it cannot be built or loaded."""
    global _cached
    with _cached_lock:
        if _cached is None:
            from ..kernels.host_build import load

            _cached = NativeLib(load())
        return _cached
