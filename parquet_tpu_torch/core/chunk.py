"""Column-chunk read/write: the page walk.

Read side mirrors the reference's chunk_reader.go: seek to the dictionary (or
first data) page offset, walk Thrift page headers until TotalCompressedSize is
consumed (:187-190), at most one dictionary page (:196-228), CRC validation
opt-in (:161-180), every size validated before allocation. Decoded pages are
concatenated into one ChunkData of typed arrays. `read_chunk` is the host
decode: the oracle the device pipeline (kernels/pipeline.py) is held against.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass

import numpy as np

from ..meta.parquet_types import (
    ColumnChunk,
    ColumnMetaData,
    DataPageHeader,
    DataPageHeaderV2,
    DictionaryPageHeader,
    IndexPageHeader,
    PageHeader,
    PageType,
)
from ..meta.thrift import CompactReader, ThriftError
from .arrays import ByteArrayData
from .compress import decompress_block
from .page import (
    DecodedPage,
    decode_data_page_v1,
    decode_data_page_v2,
    decode_dict_page,
)
from .schema import Column

__all__ = [
    "ChunkData",
    "ChunkError",
    "ChunkWindow",
    "read_chunk",
    "RawPage",
    "chunk_byte_range",
    "iter_chunk_pages",
]

# Page headers are small; peek a bounded window per header read, growing up to
# the max for headers with embedded wide statistics.
_HEADER_PEEK = 1 << 16
_HEADER_PEEK_MAX = 1 << 24


class ChunkError(ValueError):
    pass


@dataclass
class ChunkData:
    """All values of one column chunk, concatenated across pages.

    Levels are uint16 ndarrays."""

    column: Column
    num_values: int  # level entries incl. nulls
    values: object  # ndarray | ByteArrayData (non-null cells only)
    def_levels: "np.ndarray | None"
    rep_levels: "np.ndarray | None"
    dictionary: object | None = None  # decoded dict page values, if any


@dataclass
class RawPage:
    """A page as stored: parsed header + undecoded (still-compressed) payload.

    This is the unit the device pipeline batches: headers/offsets on host,
    payload decode on device.
    """

    header: PageHeader
    payload: bytes
    offset: int  # absolute file offset of the page header


_ABSENT = -(1 << 63)  # ptq_parse_page_header's "field absent" sentinel


def _header_from_slots(s) -> PageHeader:
    """Build a PageHeader from the native parser's slot array (layout in
    native/prepare.cc ptq_parse_page_header). Page-header statistics are not
    materialized: they are not consumed on read, matching the reference
    ("not used by parquet-go", README.md:47).

    Construction writes instance __dict__ directly: this runs once per page
    (the hot metadata path, SURVEY §7.3.6) and the generic TStruct kwargs
    __init__ was measurable there.
    """
    v = s.tolist()  # one C call instead of 23 np scalar boxings

    def g(i):
        return None if v[i] == _ABSENT else v[i]

    h = PageHeader.__new__(PageHeader)
    h.__dict__.update(
        type=g(1),
        uncompressed_page_size=g(2),
        compressed_page_size=g(3),
        crc=g(4),
        data_page_header=None,
        index_page_header=None,
        dictionary_page_header=None,
        data_page_header_v2=None,
    )
    if v[5] == 1:
        dp = DataPageHeader.__new__(DataPageHeader)
        dp.__dict__.update(
            num_values=g(6),
            encoding=g(7),
            definition_level_encoding=g(8),
            repetition_level_encoding=g(9),
            statistics=None,
        )
        h.data_page_header = dp
    if v[10] == 1:
        sorted_ = g(13)
        dh = DictionaryPageHeader.__new__(DictionaryPageHeader)
        dh.__dict__.update(
            num_values=g(11),
            encoding=g(12),
            is_sorted=None if sorted_ is None else bool(sorted_),
        )
        h.dictionary_page_header = dh
    if v[14] == 1:
        comp = g(21)
        d2 = DataPageHeaderV2.__new__(DataPageHeaderV2)
        d2.__dict__.update(
            num_values=g(15),
            num_nulls=g(16),
            num_rows=g(17),
            encoding=g(18),
            definition_levels_byte_length=g(19),
            repetition_levels_byte_length=g(20),
            is_compressed=None if comp is None else bool(comp),
            statistics=None,
        )
        h.data_page_header_v2 = d2
    if v[22] == 1:
        h.index_page_header = IndexPageHeader()
    return h


def _read_page_header(f) -> PageHeader:
    """Decode one page header from the stream, consuming exactly its bytes.

    Thrift needs lookahead but over-reading would swallow page data (the
    reference solves this with an unbuffered reader, helpers.go:104-106); here
    we peek a bounded window, decode, and seek back to the consumed position.
    The native compact-protocol parser (ptq_parse_page_header) reads every
    header; corrupt bytes, or a window that cannot grow past the end of the
    file, are read again by the declarative Python reader for its exact
    error, as the JAX package does.
    """
    from ..utils.native import get_native

    start = f.tell()
    peek = _HEADER_PEEK
    lib = get_native()
    while True:
        f.seek(start)
        window = f.read(peek)
        if not window:
            raise ChunkError("chunk: eof reading page header")
        try:
            slots = lib.parse_page_header(window)
        except ValueError:
            break  # corrupt: the Python reader for its exact error
        if slots is not None:
            f.seek(start + int(slots[0]))
            return _header_from_slots(slots)
        if len(window) < peek or peek >= _HEADER_PEEK_MAX:
            break  # truncated file: the Python reader for the error
        peek *= 8  # truncated window: re-peek larger
    f.seek(start)
    return read_page_header_plain(f)


def read_page_header_plain(f) -> PageHeader:
    """`_read_page_header` through the declarative Python reader alone: the
    oracle the tests hold the native parser against, and the reader that
    gives a corrupt or truncated header its exact error."""
    start = f.tell()
    peek = _HEADER_PEEK
    while True:
        f.seek(start)
        window = f.read(peek)
        if not window:
            raise ChunkError("chunk: eof reading page header")
        r = CompactReader(window)
        try:
            header = PageHeader.read(r)
        except ThriftError as e:
            # A truncated window is indistinguishable from corruption; if the
            # window wasn't exhausted (or can't grow), it really is corrupt.
            if len(window) == peek and peek < _HEADER_PEEK_MAX:
                peek *= 8
                continue
            raise ChunkError(f"chunk: corrupt page header: {e}") from e
        f.seek(start + r.pos)
        return header


def chunk_byte_range(chunk: ColumnChunk) -> tuple[int, int]:
    """Absolute (offset, size) of a chunk's page bytes in the file."""
    md: ColumnMetaData = chunk.meta_data
    if md is None:
        raise ChunkError("chunk: missing metadata")
    if chunk.file_path:
        raise ChunkError("chunk: external column chunks not supported")
    total = md.total_compressed_size
    if total is None or total < 0:
        raise ChunkError("chunk: invalid total_compressed_size")
    offset = md.data_page_offset
    if md.dictionary_page_offset is not None and md.dictionary_page_offset > 0:
        # Chunk starts at the dictionary page when present (reference:
        # chunk_reader.go:317-323). Some writers (pyarrow, empty row groups)
        # leave data_page_offset at 0, which would point at the file magic.
        if offset is None or offset <= 0 or md.dictionary_page_offset < offset:
            offset = md.dictionary_page_offset
    if offset is None or offset <= 0:
        raise ChunkError(f"chunk: invalid page offset {offset}")
    return offset, total


class ChunkWindow:
    """File-like view over one chunk's preloaded bytes, at absolute offsets.

    Lets the page walk (iter_chunk_pages/_read_page_header, which seek/tell
    in file coordinates) run against a buffer fetched with a single pread —
    one I/O per chunk instead of one per page, and no shared file-position
    state, so chunk preparation can run on worker threads.
    """

    __slots__ = ("_mv", "_base", "_pos")

    def __init__(self, buf, base: int):
        self._mv = memoryview(buf)
        self._base = base
        self._pos = 0

    def seek(self, offset: int, whence: int = 0):
        if whence == 0:
            self._pos = offset - self._base
        elif whence == 1:
            self._pos += offset
        else:
            self._pos = len(self._mv) + offset
        return self._base + self._pos

    def tell(self) -> int:
        return self._base + self._pos

    def read(self, n: int = -1):
        """Returns a zero-copy memoryview slice (payloads are ~1 MiB; all
        downstream consumers — thrift reader, codecs, np.frombuffer, crc —
        accept any buffer)."""
        if self._pos < 0 or self._pos > len(self._mv):
            return b""
        end = len(self._mv) if n is None or n < 0 else min(self._pos + n, len(self._mv))
        out = self._mv[self._pos : end]
        self._pos = end
        return out


def iter_chunk_pages(f, chunk: ColumnChunk):
    """Yield RawPage for every page of a chunk (dictionary page first if any)."""
    offset, total = chunk_byte_range(chunk)
    f.seek(offset)
    consumed = 0
    while consumed < total:
        page_start = f.tell()
        header = _read_page_header(f)
        size = header.compressed_page_size
        if size is None or size < 0:
            raise ChunkError(f"chunk: invalid compressed page size {size}")
        payload = f.read(size)
        if len(payload) != size:
            raise ChunkError("chunk: truncated page payload")
        yield RawPage(header=header, payload=payload, offset=page_start)
        consumed += (f.tell() - page_start)


def _check_crc(header: PageHeader, payload: bytes) -> None:
    if header.crc is None:
        return
    actual = zlib.crc32(payload) & 0xFFFFFFFF
    expected = header.crc & 0xFFFFFFFF
    if actual != expected:
        raise ChunkError(
            f"chunk: page CRC mismatch (stored {expected:#x}, computed {actual:#x})"
        )


def read_chunk(
    f,
    chunk: ColumnChunk,
    column: Column,
    validate_crc: bool = False,
) -> ChunkData:
    """Read and decode all pages of one column chunk (host path)."""
    md = chunk.meta_data
    codec = md.codec or 0
    dictionary = None
    pages: list[DecodedPage] = []
    seen_data_values = 0
    expected = md.num_values or 0
    for raw in iter_chunk_pages(f, chunk):
        header = raw.header
        ptype = header.type
        if ptype == int(PageType.DICTIONARY_PAGE):
            if dictionary is not None:
                raise ChunkError("chunk: more than one dictionary page")
            if pages:
                raise ChunkError("chunk: dictionary page after data pages")
            if validate_crc:
                _check_crc(header, raw.payload)
            block = decompress_block(
                raw.payload, codec, header.uncompressed_page_size or 0
            )
            dictionary = decode_dict_page(header, block, column)
        elif ptype == int(PageType.DATA_PAGE):
            if validate_crc:
                _check_crc(header, raw.payload)
            block = decompress_block(
                raw.payload, codec, header.uncompressed_page_size or 0
            )
            dict_size = len(dictionary) if dictionary is not None else None
            page = decode_data_page_v1(header, block, column, dict_size)
            pages.append(page)  # dict pages materialize at chunk level
            seen_data_values += page.num_values
        elif ptype == int(PageType.DATA_PAGE_V2):
            if validate_crc:
                _check_crc(header, raw.payload)
            dict_size = len(dictionary) if dictionary is not None else None
            page = decode_data_page_v2(header, raw.payload, column, dict_size, codec)
            pages.append(page)  # dict pages materialize at chunk level
            seen_data_values += page.num_values
        elif ptype == int(PageType.INDEX_PAGE):
            continue  # skip, like the reference
        else:
            raise ChunkError(f"chunk: unknown page type {ptype}")
    if seen_data_values != expected:
        raise ChunkError(
            f"chunk: pages hold {seen_data_values} values, metadata says {expected}"
        )
    return _concat_pages(column, pages, dictionary)


def _concat_pages(column: Column, pages: list[DecodedPage], dictionary) -> ChunkData:
    num_values = sum(p.num_values for p in pages)
    def_levels = None
    rep_levels = None
    if column.max_def > 0:
        def_levels = _concat([p.def_levels for p in pages], np.uint16)
    if column.max_rep > 0:
        rep_levels = _concat([p.rep_levels for p in pages], np.uint16)
    from ..meta.parquet_types import Type

    if (
        dictionary is not None
        and pages
        and all(p.values is None and p.indices is not None for p in pages)
    ):
        # every data page is dictionary-encoded and still unmaterialized:
        # ONE chunk-level gather instead of a per-page take + a second
        # byte-array concat (halves the copies on dict-string chunks — the
        # dominant cost of materializing dictionary columns)
        idx = (
            np.concatenate([np.asarray(p.indices) for p in pages])
            if len(pages) > 1
            else np.asarray(pages[0].indices)
        )
        try:
            values = (
                dictionary.take(idx)
                if isinstance(dictionary, ByteArrayData)
                else np.asarray(dictionary)[idx]
            )
        except (IndexError, ValueError) as e:
            # corrupt index stream, not a programming error: stay typed
            raise ChunkError(f"chunk: dictionary index out of range: {e}") from e
        return ChunkData(
            column=column,
            num_values=num_values,
            values=values,
            def_levels=def_levels,
            rep_levels=rep_levels,
            dictionary=dictionary,
        )
    if dictionary is not None:
        for p in pages:  # mixed dict/PLAIN chunk: per-page materialize
            p.materialize(dictionary)
    value_parts = [p.values for p in pages]
    if any(isinstance(v, ByteArrayData) for v in value_parts):
        values = _concat_byte_arrays([v for v in value_parts if v is not None])
    else:
        arrs = [np.asarray(v) for v in value_parts if v is not None and len(v)]
        if arrs:
            values = np.concatenate(arrs) if len(arrs) > 1 else arrs[0]
        elif column.type == Type.BYTE_ARRAY:
            values = ByteArrayData(offsets=np.zeros(1, dtype=np.int64), data=b"")
        else:
            values = np.empty(0, dtype=_empty_dtype(column))
    return ChunkData(
        column=column,
        num_values=num_values,
        values=values,
        def_levels=def_levels,
        rep_levels=rep_levels,
        dictionary=dictionary,
    )


def _concat(parts, dtype):
    arrs = [p for p in parts if p is not None]
    if not arrs:
        return np.empty(0, dtype=dtype)
    return np.concatenate(arrs) if len(arrs) > 1 else arrs[0]


def _concat_byte_arrays(parts: list) -> ByteArrayData:
    if len(parts) == 1:
        return parts[0]
    datas = []
    offsets = [np.zeros(1, dtype=np.int64)]
    base = 0
    for p in parts:
        datas.append(p.data)
        offsets.append(p.offsets[1:] + base)
        base += len(p.data)
    return ByteArrayData(offsets=np.concatenate(offsets), data=b"".join(datas))


def _empty_dtype(column: Column):
    from ..meta.parquet_types import Type

    return {
        Type.BOOLEAN: np.bool_,
        Type.INT32: np.int32,
        Type.INT64: np.int64,
        Type.FLOAT: np.float32,
        Type.DOUBLE: np.float64,
    }.get(column.type, np.uint8)
