"""Data page (V1/V2) and dictionary page decode/encode.

Layout semantics follow the reference:
  V1 (reference: page_v1.go): [rep levels: 4-byte size + hybrid] [def levels:
     same] [values] — all inside one optionally-compressed block; optional CRC
     over the compressed block.
  V2 (reference: page_v2.go): rep + def level streams stored RAW (uncompressed,
     no size prefix — sizes live in the page header) ahead of the
     optionally-compressed values block; CRC over rep+def+compressed values.
  Dict page (reference: page_dict.go): PLAIN values of the column type.

Decode is page-at-a-time into typed arrays. The `values` of a dictionary-encoded
page stay as (indices, dictionary) until materialization so the device pipeline
can batch the gathers (kernels/pipeline.py).
"""

from __future__ import annotations

import struct as _struct
import zlib
from contextlib import contextmanager as _contextmanager
from dataclasses import dataclass

import numpy as np

from ..meta.file_meta import ParquetFileError
from ..meta.parquet_types import (
    DataPageHeader,
    DataPageHeaderV2,
    DictionaryPageHeader,
    Encoding,
    PageHeader,
    Type,
)
from ..ops import bytearray as ba_ops
from ..ops import delta as delta_ops
from ..ops import plain as plain_ops
from ..ops.dictionary import decode_dict_indices, encode_dict_indices
from ..ops.levels import (
    decode_levels_v1,
    decode_levels_v2,
    encode_levels_v1,
    encode_levels_v2,
)
from .arrays import ByteArrayData
from .compress import compress_block, decompress_block
from .schema import Column
from ..utils import metrics as _metrics
from ..utils.trace import stage

__all__ = ["DecodedPage", "PageError", "decode_data_page_v1", "decode_data_page_v2",
           "decode_dict_page", "encode_data_page_v1", "encode_data_page_v2",
           "encode_dict_page", "frame_page"]


class PageError(ValueError):
    pass


class MissingDictionaryError(PageError):
    """A data page references a chunk dictionary that is absent (or failed
    to decode). Distinct type so triage tooling (parquet-tool verify) can
    tell a DEPENDENT failure — data pages orphaned by one rotten dictionary
    page — from independent corruption, without matching message text."""


@_contextmanager
def typed_page_errors(what: str):
    """Context manager converting ANY stray exception from decoding
    untrusted page bytes into a typed PageError (already-typed Parquet
    errors pass through). Corrupt input must never surface as a raw
    struct.error / zlib.error / IndexError / OverflowError."""
    try:
        yield
    except (PageError, ParquetFileError):
        raise
    except ValueError as e:
        # ChunkError is a ValueError defined downstream (core.chunk imports
        # this module); keep its exact message when it bubbles through a
        # page decode
        if type(e).__name__ == "ChunkError":
            raise
        raise PageError(f"page: corrupt {what}: {e}") from e
    except (
        KeyError,
        IndexError,
        OverflowError,
        ZeroDivisionError,
        TypeError,
        EOFError,
        _struct.error,
        zlib.error,
    ) as e:
        # MemoryError deliberately NOT converted: genuine memory pressure on
        # a valid page is not corruption, and under on_error='skip' a typed
        # rewrap would silently quarantine valid rows (header-driven bomb
        # allocations are already rejected by the preflight size guards
        # before any allocation happens)
        raise PageError(f"page: corrupt {what}: {e!r}") from e


@dataclass
class DecodedPage:
    """One decoded data page.

    num_values counts level entries (incl. nulls/empty lists); `values` holds
    only the non-null cells. For dictionary-encoded pages `indices` is set and
    `values` is None until materialized against the chunk dictionary.
    """

    num_values: int
    def_levels: np.ndarray | None
    rep_levels: np.ndarray | None
    values: object | None = None
    indices: np.ndarray | None = None

    def materialize(self, dictionary):
        if self.values is None and self.indices is not None:
            if dictionary is None:
                raise MissingDictionaryError(
                    "page: dictionary-encoded page but no dictionary page"
                )
            try:
                if isinstance(dictionary, ByteArrayData):
                    self.values = dictionary.take(self.indices)
                else:
                    self.values = np.asarray(dictionary)[self.indices]
            except (IndexError, ValueError) as e:
                # corrupt index stream, not a programming error: stay typed
                raise PageError(
                    f"page: dictionary index out of range: {e}"
                ) from e
        return self


_DICT_ENCODINGS = (int(Encoding.PLAIN_DICTIONARY), int(Encoding.RLE_DICTIONARY))


def _decode_values(
    data, n: int, encoding: int, column: Column, dict_size: int | None
):
    """Value-decoder selection matrix by (type, encoding)
    (reference: chunk_reader.go:41-159)."""
    ptype = column.type
    if encoding in _DICT_ENCODINGS:
        if dict_size is None:
            raise MissingDictionaryError(
                "page: dictionary encoding without dictionary"
            )
        return None, decode_dict_indices(data, n, dict_size)
    if encoding == int(Encoding.PLAIN):
        values, _ = plain_ops.decode_plain(data, n, ptype, column.type_length)
        return values, None
    if encoding == int(Encoding.DELTA_BINARY_PACKED):
        if ptype == Type.INT32:
            values, _ = delta_ops.decode_delta(data, 32, max_total=n)
        elif ptype == Type.INT64:
            values, _ = delta_ops.decode_delta(data, 64, max_total=n)
        else:
            raise PageError(f"page: DELTA_BINARY_PACKED unsupported for {ptype}")
        if len(values) < n:
            raise PageError(
                f"page: delta stream has {len(values)} values, page needs {n}"
            )
        return values[:n], None
    if encoding == int(Encoding.DELTA_LENGTH_BYTE_ARRAY):
        if ptype != Type.BYTE_ARRAY:
            raise PageError("page: DELTA_LENGTH_BYTE_ARRAY only for BYTE_ARRAY")
        values, _ = ba_ops.decode_delta_length_byte_array(data, n)
        return values, None
    if encoding == int(Encoding.DELTA_BYTE_ARRAY):
        if ptype != Type.BYTE_ARRAY:
            raise PageError("page: DELTA_BYTE_ARRAY only for BYTE_ARRAY")
        values, _ = ba_ops.decode_delta_byte_array(data, n)
        return values, None
    if encoding == int(Encoding.RLE):
        if ptype != Type.BOOLEAN:
            raise PageError("page: RLE value encoding only for BOOLEAN")
        # 4-byte length prefix + hybrid at width 1 (reference: type_boolean.go:100-146)
        levels, _ = decode_levels_v1(data, n, 1)
        return levels.astype(bool), None
    if encoding == int(Encoding.BYTE_STREAM_SPLIT):
        from ..ops.byte_stream_split import decode_byte_stream_split

        try:
            return decode_byte_stream_split(data, n, ptype, column.type_length), None
        except ValueError as e:
            raise PageError(f"page: {e}") from e
    try:
        name = Encoding(encoding).name
    except ValueError:
        name = str(encoding)
    raise PageError(f"page: unsupported value encoding {name} for {ptype}")


def decode_data_page_v1(
    header: PageHeader, block: bytes, column: Column, dict_size: int | None
) -> DecodedPage:
    h: DataPageHeader = header.data_page_header
    if h is None:
        raise PageError("page: DATA_PAGE without data_page_header")
    n = h.num_values or 0
    if n < 0:
        raise PageError(f"page: negative num_values {n}")
    buf = memoryview(block)
    pos = 0
    rep = None
    with typed_page_errors("v1 level stream"):
        if column.max_rep > 0:
            rep, used = decode_levels_v1(buf, n, column.max_rep)
            pos += used
        dfl = None
        non_null = n
        if column.max_def > 0:
            dfl, used = decode_levels_v1(buf[pos:], n, column.max_def)
            pos += used
            non_null = int((dfl == column.max_def).sum())
    with typed_page_errors("v1 value stream"):
        values, indices = _decode_values(
            buf[pos:], non_null, h.encoding, column, dict_size
        )
    _metrics.page_decoded(_metrics.encoding_name(h.encoding), nbytes=len(block))
    return DecodedPage(
        num_values=n, def_levels=dfl, rep_levels=rep, values=values, indices=indices
    )


def decode_data_page_v2(
    header: PageHeader,
    raw: bytes,
    column: Column,
    dict_size: int | None,
    codec: int,
) -> DecodedPage:
    """`raw` is the page exactly as stored: levels raw + values (maybe compressed)."""
    h: DataPageHeaderV2 = header.data_page_header_v2
    if h is None:
        raise PageError("page: DATA_PAGE_V2 without data_page_header_v2")
    n = h.num_values or 0
    rep_len = h.repetition_levels_byte_length or 0
    def_len = h.definition_levels_byte_length or 0
    if rep_len < 0 or def_len < 0 or rep_len + def_len > len(raw):
        raise PageError("page: v2 level sizes exceed page")
    buf = memoryview(raw)
    rep = None
    with typed_page_errors("v2 level stream"):
        if column.max_rep > 0:
            rep = decode_levels_v2(buf[:rep_len], n, column.max_rep)
        elif rep_len:
            raise PageError("page: v2 rep levels present for flat column")
        dfl = None
        non_null = n
        if column.max_def > 0:
            dfl = decode_levels_v2(buf[rep_len : rep_len + def_len], n, column.max_def)
            non_null = int((dfl == column.max_def).sum())
    if h.num_nulls is not None and dfl is not None and column.max_rep == 0:
        # FLAT columns only: for repeated columns parquet-cpp counts
        # num_nulls as null VALUES (def one below max at the element or a
        # struct member), excluding empty-list/ancestor placeholders — the
        # "non_null = num_values - num_nulls" invariant does not hold for
        # its nested pages (found by differential fuzz vs pyarrow), so the
        # levels are the only trustworthy source there
        if n - non_null != h.num_nulls:
            raise PageError(
                f"page: v2 header claims {h.num_nulls} nulls, levels say {n - non_null}"
            )
    values_block = bytes(buf[rep_len + def_len :])
    if h.is_compressed is None or h.is_compressed:
        uncompressed = (header.uncompressed_page_size or 0) - rep_len - def_len
        with stage("decompress", len(values_block)):
            values_block = decompress_block(values_block, codec, max(uncompressed, 0))
    with typed_page_errors("v2 value stream"):
        values, indices = _decode_values(
            values_block, non_null, h.encoding, column, dict_size
        )
    _metrics.page_decoded(
        _metrics.encoding_name(h.encoding), nbytes=header.uncompressed_page_size or 0
    )
    return DecodedPage(
        num_values=n, def_levels=dfl, rep_levels=rep, values=values, indices=indices
    )


def decode_dict_page(header: PageHeader, block: bytes, column: Column, count_metrics: bool = True):
    """Decode a dictionary page's PLAIN values (reference: page_dict.go).
    count_metrics=False lets the fused native walk count its pages once
    the whole chunk plan commits (kernels/pipeline.py): counting here would
    count the dictionary page twice if the plan fell back to the staged
    walk."""
    h: DictionaryPageHeader = header.dictionary_page_header
    if h is None:
        raise PageError("page: DICTIONARY_PAGE without header")
    n = h.num_values or 0
    if n < 0:
        raise PageError("page: negative dictionary size")
    enc = h.encoding
    if enc not in (int(Encoding.PLAIN), int(Encoding.PLAIN_DICTIONARY)):
        raise PageError(f"page: dictionary page encoding {enc} unsupported")
    with typed_page_errors("dictionary page"):
        values, consumed = plain_ops.decode_plain(
            block, n, column.type, column.type_length
        )
    if consumed != len(block):
        # Strict full decode (reference: page_dict.go:35-72): trailing bytes
        # mean the header lied about num_values or the page is corrupt.
        raise PageError(
            f"page: dictionary page has {len(block) - consumed} trailing bytes"
        )
    if count_metrics:
        _metrics.page_decoded(_metrics.encoding_name(enc), nbytes=len(block))
    return values


# -- write side ----------------------------------------------------------------


def frame_page(
    values_raw: bytes,
    n: int,
    encoding: Encoding,
    codec: int,
    version: int,
    with_crc: bool = False,
    rep_block: bytes = b"",
    def_block: bytes = b"",
    num_nulls: int = 0,
    num_rows: int | None = None,
) -> tuple[PageHeader, bytes]:
    """One data page from its encoded parts: `n` level entries (values for a
    flat REQUIRED column), the encoded levels and the value stream. V1
    compresses levels and values as one block; V2 keeps the level blocks
    uncompressed in front of the compressed values."""
    if version == 1:
        raw = rep_block + def_block + values_raw
        block = compress_block(raw, codec)
        header = PageHeader(
            type=0,
            uncompressed_page_size=len(raw),
            compressed_page_size=len(block),
            data_page_header=DataPageHeader(
                num_values=n,
                encoding=int(encoding),
                definition_level_encoding=int(Encoding.RLE),
                repetition_level_encoding=int(Encoding.RLE),
            ),
        )
    else:
        block = rep_block + def_block + compress_block(values_raw, codec)
        header = PageHeader(
            type=3,
            uncompressed_page_size=len(rep_block) + len(def_block) + len(values_raw),
            compressed_page_size=len(block),
            data_page_header_v2=DataPageHeaderV2(
                num_values=n,
                num_nulls=num_nulls,
                num_rows=n if num_rows is None else num_rows,
                encoding=int(encoding),
                definition_levels_byte_length=len(def_block),
                repetition_levels_byte_length=len(rep_block),
                is_compressed=True,
            ),
        )
    if with_crc:
        header.crc = _crc32_signed(block)
    return header, block


def encode_data_page_v1(
    column: Column,
    values,
    def_levels,
    rep_levels,
    encoding: Encoding,
    codec: int,
    dict_size: int | None = None,
    with_crc: bool = False,
) -> tuple[PageHeader, bytes]:
    n = _count_level_entries(values, def_levels)
    vals = _encode_values(values, encoding, column, dict_size)
    rep_block = encode_levels_v1(rep_levels, column.max_rep) if column.max_rep > 0 else b""
    def_block = encode_levels_v1(def_levels, column.max_def) if column.max_def > 0 else b""
    return frame_page(vals, n, encoding, codec, 1, with_crc, rep_block, def_block)


def encode_data_page_v2(
    column: Column,
    values,
    def_levels,
    rep_levels,
    encoding: Encoding,
    codec: int,
    dict_size: int | None = None,
    with_crc: bool = False,
) -> tuple[PageHeader, bytes]:
    n = _count_level_entries(values, def_levels)
    rep_block = (
        encode_levels_v2(rep_levels, column.max_rep) if column.max_rep > 0 else b""
    )
    def_block = (
        encode_levels_v2(def_levels, column.max_def) if column.max_def > 0 else b""
    )
    values_raw = _encode_values(values, encoding, column, dict_size)
    num_nulls = 0
    num_rows = n
    if def_levels is not None and column.max_def > 0:
        dl = np.asarray(def_levels)
        num_nulls = int((dl != column.max_def).sum())
    if rep_levels is not None and column.max_rep > 0:
        num_rows = int((np.asarray(rep_levels) == 0).sum())
    return frame_page(values_raw, n, encoding, codec, 2, with_crc, rep_block, def_block,
                      num_nulls, num_rows)


def encode_dict_page(
    column: Column, dict_values, codec: int, with_crc: bool = False
) -> tuple[PageHeader, bytes]:
    raw = plain_ops.encode_plain(dict_values, column.type, column.type_length)
    block = compress_block(raw, codec)
    n = len(dict_values)
    header = PageHeader(
        type=2,
        uncompressed_page_size=len(raw),
        compressed_page_size=len(block),
        dictionary_page_header=DictionaryPageHeader(
            num_values=n, encoding=int(Encoding.PLAIN), is_sorted=False
        ),
    )
    if with_crc:
        header.crc = _crc32_signed(block)
    return header, block


def _count_level_entries(values, def_levels) -> int:
    if def_levels is not None:
        return len(def_levels)
    if isinstance(values, ByteArrayData):
        return len(values)
    return len(values)


def _encode_values(values, encoding: Encoding, column: Column, dict_size) -> bytes:
    ptype = column.type
    e = int(encoding)
    if e in _DICT_ENCODINGS:
        # `values` are indices here; dictionary page is written separately.
        return encode_dict_indices(values, dict_size)
    if e == int(Encoding.PLAIN):
        return plain_ops.encode_plain(values, ptype, column.type_length)
    if e == int(Encoding.DELTA_BINARY_PACKED):
        nbits = 32 if ptype == Type.INT32 else 64
        return delta_ops.encode_delta(np.asarray(values), nbits)
    if e == int(Encoding.DELTA_LENGTH_BYTE_ARRAY):
        return ba_ops.encode_delta_length_byte_array(values)
    if e == int(Encoding.DELTA_BYTE_ARRAY):
        return ba_ops.encode_delta_byte_array(values)
    if e == int(Encoding.RLE) and ptype == Type.BOOLEAN:
        return encode_levels_v1(np.asarray(values).astype(np.uint16), 1)
    if e == int(Encoding.BYTE_STREAM_SPLIT):
        from ..ops.byte_stream_split import encode_byte_stream_split

        try:
            return encode_byte_stream_split(values, ptype, column.type_length)
        except ValueError as err:
            raise PageError(f"page: {err}") from err
    raise PageError(f"page: unsupported write encoding {encoding} for {ptype}")


def _crc32_signed(block: bytes) -> int:
    """CRC-32 over the stored block, as a signed i32 for the Thrift field."""
    v = zlib.crc32(block) & 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v
