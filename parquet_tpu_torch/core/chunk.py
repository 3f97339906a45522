"""Column-chunk read/write: the page walk.

Read side mirrors the reference's chunk_reader.go: seek to the dictionary (or
first data) page offset, walk Thrift page headers until TotalCompressedSize is
consumed (:187-190), at most one dictionary page (:196-228), CRC validation
opt-in (:161-180), every size validated before allocation. Decoded pages are
concatenated into one ChunkData of typed arrays. `read_chunk` is the host
decode: the oracle the device pipeline (kernels/pipeline.py) is held against.
`read_chunk_row_ranges` decodes only the pages of a chunk that the page
index (OffsetIndex) says cover given row ranges: the selective page decode
of FileReader.iter_rows(filters=).
"""

from __future__ import annotations

import time as _time
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
from ..utils import metrics as _metrics
from ..utils.trace import active as trace_active
from ..utils.trace import bump, span, stage
from .alloc import decoded_nbytes
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
    "read_chunk_row_ranges",
    "RawPage",
    "chunk_byte_range",
    "iter_chunk_pages",
    "iter_page_sites",
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
    # dictionary-preserving reads only (read_chunk keep_dict_indices=True):
    # int32 indices of the non-null cells; values is None then
    indices: "np.ndarray | None" = None


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


def iter_page_sites(f, chunk: ColumnChunk):
    """Yield (header_offset, header, header_len, payload_len) for every page
    of a chunk WITHOUT reading payloads — the page-location walk of the
    fault harness's page mapper (testing.faults.map_pages). Raises
    ChunkError on a header that cannot be parsed or a page size escaping
    the chunk's byte range. Size errors carry `.stage = "layout"` so a
    caller can classify them without matching message text."""
    offset, total = chunk_byte_range(chunk)
    pos = offset
    while pos < offset + total:
        f.seek(pos)
        header = _read_page_header(f)
        hlen = f.tell() - pos
        plen = header.compressed_page_size
        if plen is None or plen < 0:
            # same invariant (and message) as the read path below: an absent
            # size must NOT silently walk on as a 0-byte payload
            err = ChunkError(f"chunk: invalid compressed page size {plen}")
            err.stage = "layout"
            raise err
        if pos + hlen + plen > offset + total:
            err = ChunkError(
                f"chunk: compressed page size {plen} exceeds chunk bounds"
            )
            err.stage = "layout"
            raise err
        yield pos, header, hlen, plen
        pos += hlen + plen


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
        with stage("io", size):
            payload = f.read(size)
        if len(payload) != size:
            raise ChunkError("chunk: truncated page payload")
        yield RawPage(header=header, payload=payload, offset=page_start)
        consumed += (f.tell() - page_start)


def read_chunk_row_ranges(
    f,
    chunk: ColumnChunk,
    column: Column,
    offset_index,
    ranges: list,
    num_rows: int,
    validate_crc: bool = False,
    alloc=None,
) -> ChunkData:
    """Decode ONLY the pages covering `ranges` (sorted disjoint row spans),
    using the chunk's OffsetIndex to seek straight to each admitted page —
    non-admitted pages are neither read nor decompressed. Returns a ChunkData
    holding exactly the rows of `ranges`, in order (row-aligned with any
    other column decoded with the same ranges). Flat columns only
    (max_rep == 0): repeated pages interleave rows and values, which range
    slicing by row index cannot express.

    Beyond the reference (which always decodes whole chunks); the payoff is
    selective filtered scans — decode cost proportional to matching pages,
    not file size.
    """
    if column.max_rep > 0:
        raise ChunkError("chunk: range decode requires a flat column")
    md = chunk.meta_data
    codec = md.codec or 0
    locs = offset_index.page_locations or []
    if not locs:
        raise ChunkError("chunk: empty offset index")
    firsts = [loc.first_row_index for loc in locs] + [num_rows]
    dictionary = None
    dict_off = md.dictionary_page_offset
    if dict_off is not None and dict_off > 0 and dict_off < (locs[0].offset or 0):
        f.seek(dict_off)
        header = _read_page_header(f)
        payload = f.read(header.compressed_page_size or 0)
        if validate_crc:
            _check_crc(header, payload)
        if alloc is not None:
            alloc.check(header.uncompressed_page_size or 0)
        block = decompress_block(payload, codec, header.uncompressed_page_size or 0)
        dictionary = decode_dict_page(header, block, column)
        if alloc is not None:
            alloc.register_buffers(dictionary)
    pages: list[DecodedPage] = []
    ri = 0
    n_out = 0
    for k, loc in enumerate(locs):
        a, b = firsts[k], firsts[k + 1]
        while ri < len(ranges) and ranges[ri][1] <= a:
            ri += 1
        if ri >= len(ranges):
            break
        if ranges[ri][0] >= b:
            continue  # page admitted no range: skip without reading
        f.seek(loc.offset)
        header = _read_page_header(f)
        size = header.compressed_page_size or 0
        payload = f.read(size)
        if len(payload) != size:
            raise ChunkError("chunk: truncated page payload")
        if validate_crc:
            _check_crc(header, payload)
        if alloc is not None:
            # ceiling BEFORE decompression, like read_chunk: a header
            # claiming a huge uncompressed size must not allocate
            alloc.check(header.uncompressed_page_size or 0)
        if header.type == int(PageType.DATA_PAGE):
            block = decompress_block(payload, codec, header.uncompressed_page_size or 0)
            dict_size = len(dictionary) if dictionary is not None else None
            est = _precharge(alloc, header.data_page_header, len(block))
            page = decode_data_page_v1(header, block, column, dict_size)
        elif header.type == int(PageType.DATA_PAGE_V2):
            dict_size = len(dictionary) if dictionary is not None else None
            est = _precharge(
                alloc, header.data_page_header_v2, header.uncompressed_page_size or 0
            )
            page = decode_data_page_v2(header, payload, column, dict_size, codec)
        else:
            raise ChunkError(f"chunk: offset index points at page type {header.type}")
        if page.num_values != b - a:
            raise ChunkError(
                f"chunk: page holds {page.num_values} rows, offset index says {b - a}"
            )
        _account_page(alloc, est, page, dictionary)
        page.materialize(dictionary)
        # slice this page down to the admitted rows
        rj = ri
        keep = []
        while rj < len(ranges) and ranges[rj][0] < b:
            s = max(ranges[rj][0], a) - a
            e = min(ranges[rj][1], b) - a
            keep.append((s, e))
            rj += 1
        pages.append(_slice_page(page, keep, column))
        n_out += sum(e - s for s, e in keep)
    data = _concat_pages(column, pages, dictionary)
    if data.num_values != n_out:
        raise ChunkError("chunk: range decode row-count mismatch")
    return data


def _slice_page(page: DecodedPage, keep: list, column: Column) -> DecodedPage:
    """Restrict one decoded flat page to local row spans `keep`."""
    if len(keep) == 1 and keep[0] == (0, page.num_values):
        return page
    dl = page.def_levels
    n = sum(e - s for s, e in keep)
    if dl is None:
        # no nulls: rows ARE value indices
        vals = _concat_value_slices(page.values, keep)
        return DecodedPage(num_values=n, def_levels=None, rep_levels=None, values=vals)
    # nulls: map row spans to value spans via the non-null prefix sum
    prefix = np.zeros(len(dl) + 1, dtype=np.int64)
    np.cumsum(dl == column.max_def, out=prefix[1:])
    vspans = [(int(prefix[s]), int(prefix[e])) for s, e in keep]
    vals = _concat_value_slices(page.values, vspans)
    new_dl = np.concatenate([dl[s:e] for s, e in keep]) if keep else dl[:0]
    return DecodedPage(
        num_values=n, def_levels=new_dl, rep_levels=None, values=vals
    )


def _concat_value_slices(values, spans: list):
    if isinstance(values, ByteArrayData):
        o = values.offsets
        parts = [
            ByteArrayData(
                offsets=o[s : e + 1] - int(o[s]),
                data=values.data[int(o[s]) : int(o[e])],
            )
            for s, e in spans
        ]
        if not parts:
            return ByteArrayData(offsets=np.zeros(1, dtype=np.int64), data=b"")
        return _concat_byte_arrays(parts)  # returns parts[0] unchanged for one
    arr = np.asarray(values)
    if len(spans) == 1:
        s, e = spans[0]
        return arr[s:e]
    return (
        np.concatenate([arr[s:e] for s, e in spans]) if spans else arr[:0]
    )


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
    alloc=None,
    keep_dict_indices: bool = False,
) -> ChunkData:
    """Read and decode all pages of one column chunk (host path). `alloc`
    (a core.alloc.AllocTracker) checks each page's claimed size before it
    decompresses and charges what each page decodes to.

    keep_dict_indices=True returns ChunkData with `indices` set (and
    values=None) when EVERY data page is dictionary-encoded — the
    dictionary-preserving columnar lane (to_arrow read_dictionary=);
    mixed chunks fall back to materialized values.

    The whole chunk runs under a "chunk" span (page spans and decompress /
    decode stages nest inside it when a trace is active) and feeds the
    always-on chunk_decode_seconds histogram."""
    t0 = _time.perf_counter()
    with span("chunk", {"column": column.path_str}):
        out = _read_chunk_impl(
            f, chunk, column, validate_crc, alloc, keep_dict_indices
        )
    _metrics.observe("chunk_decode_seconds", _time.perf_counter() - t0)
    return out


def _read_chunk_impl(
    f, chunk: ColumnChunk, column: Column, validate_crc: bool, alloc,
    keep_dict_indices: bool = False,
) -> ChunkData:
    md = chunk.meta_data
    codec = md.codec or 0
    dictionary = None
    pages: list[DecodedPage] = []
    seen_data_values = 0
    deferred_gather = 0
    expected = md.num_values or 0
    # the staged walk: the counterpart of the fused walk's
    # prepare_fused_engaged, so a trace tells which walk a read took
    bump("prepare_staged_chunk")
    collecting = trace_active()  # span args only when someone listens
    page_idx = 0
    for raw in iter_chunk_pages(f, chunk):
        header = raw.header
        if alloc is not None:
            alloc.check(header.uncompressed_page_size or 0)
        ptype = header.type
        with span("page", {"page": page_idx, "type": int(ptype)} if collecting else None):
            if ptype == int(PageType.DICTIONARY_PAGE):
                if dictionary is not None:
                    raise ChunkError("chunk: more than one dictionary page")
                if pages:
                    raise ChunkError("chunk: dictionary page after data pages")
                if validate_crc:
                    _check_crc(header, raw.payload)
                with stage("decompress", len(raw.payload)):
                    block = decompress_block(
                        raw.payload, codec, header.uncompressed_page_size or 0
                    )
                dictionary = decode_dict_page(header, block, column)
                if alloc is not None:
                    alloc.register_buffers(dictionary)
            elif ptype == int(PageType.DATA_PAGE):
                if validate_crc:
                    _check_crc(header, raw.payload)
                with stage("decompress", len(raw.payload)):
                    block = decompress_block(
                        raw.payload, codec, header.uncompressed_page_size or 0
                    )
                dict_size = len(dictionary) if dictionary is not None else None
                est = _precharge(alloc, header.data_page_header, len(block))
                with stage("decode", len(block)):
                    page = decode_data_page_v1(header, block, column, dict_size)
                deferred_gather += _account_page(
                    alloc, est, page, dictionary, keep_dict_indices
                ) or 0
                pages.append(page)  # dict pages materialize at chunk level
                seen_data_values += page.num_values
            elif ptype == int(PageType.DATA_PAGE_V2):
                if validate_crc:
                    _check_crc(header, raw.payload)
                dict_size = len(dictionary) if dictionary is not None else None
                est = _precharge(
                    alloc, header.data_page_header_v2, header.uncompressed_page_size or 0
                )
                with stage("decode", header.uncompressed_page_size or 0):
                    page = decode_data_page_v2(header, raw.payload, column, dict_size, codec)
                deferred_gather += _account_page(
                    alloc, est, page, dictionary, keep_dict_indices
                ) or 0
                pages.append(page)  # dict pages materialize at chunk level
                seen_data_values += page.num_values
            elif ptype == int(PageType.INDEX_PAGE):
                page_idx += 1
                continue  # skip, like the reference
            else:
                raise ChunkError(f"chunk: unknown page type {ptype}")
        page_idx += 1
    if seen_data_values != expected:
        raise ChunkError(
            f"chunk: pages hold {seen_data_values} values, metadata says {expected}"
        )
    if keep_dict_indices and deferred_gather and alloc is not None:
        will_keep = (
            dictionary is not None
            and pages
            and all(p.values is None and p.indices is not None for p in pages)
        )
        if not will_keep:
            # a mixed chunk falls back to materialization: charge the
            # gather the per-page accounting deferred
            alloc.check(deferred_gather)
            alloc.register(deferred_gather)
    return _concat_pages(column, pages, dictionary, keep_dict_indices)


def _precharge(alloc, page_header, block_len: int):
    """Bound a page's decode allocations BEFORE they happen: levels (2+2 B)
    plus indices/values (<= 8 B) per header-claimed value, plus the block
    itself. A header claiming a huge num_values trips the ceiling here, not
    in the allocator."""
    if alloc is None:
        return 0
    n = (page_header.num_values or 0) if page_header is not None else 0
    est = n * 12 + block_len
    alloc.register(est)
    return est


def _account_page(
    alloc, est: int, page: DecodedPage, dictionary, keep_dict_indices=False
) -> int:
    """Swap the pre-charge for the page's actual decoded footprint, charging
    the upcoming dictionary gather before materialize() allocates it (a few
    RLE bytes can gather to n x longest-dict-entry bytes). A dictionary-
    preserving read (keep_dict_indices) never gathers, so only the indices
    themselves are charged; the gather it deferred is returned."""
    if alloc is None:
        return 0
    alloc.release(est)
    gather = 0
    if page.indices is not None and isinstance(dictionary, ByteArrayData):
        lengths = np.diff(dictionary.offsets)
        gather = int(lengths[page.indices].sum()) + (len(page.indices) + 1) * 8
    elif page.indices is not None and dictionary is not None:
        gather = len(page.indices) * np.asarray(dictionary).itemsize
    deferred = 0
    if keep_dict_indices:
        # indices stay indices: the caller re-charges the gather only if
        # the chunk falls back to materialization
        deferred, gather = gather, 0
    alloc.register(
        gather
        + sum(
            decoded_nbytes(b)
            for b in (page.values, page.indices, page.def_levels, page.rep_levels)
        )
    )
    return deferred


def _concat_pages(
    column: Column, pages: list[DecodedPage], dictionary,
    keep_dict_indices: bool = False,
) -> ChunkData:
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
        if keep_dict_indices:
            return ChunkData(
                column=column,
                num_values=num_values,
                values=None,
                def_levels=def_levels,
                rep_levels=rep_levels,
                dictionary=dictionary,
                indices=idx.astype(np.int32, copy=False),
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
