"""Chunk encode: one column chunk's pages and footer structs, and the group
stitch and commit.

A copy of parquet_tpu/sink/encoder.py, cut to its staged rung (the per-page
Python loop over core/page.py's encoders, the JAX package's byte oracle) and
the serial seams FileWriter uses:

  encode_chunk()      one column chunk -> page bytes + metadata with offsets
                      RELATIVE to the chunk start; a pure function of
                      (config, builder snapshot).
  assemble_group()    stitch encoded chunks into one row group, offsets
                      relative to the GROUP start.
  commit_group()      rebase a group to its absolute file position and write
                      its bytes to the sink.

The JAX module's fused native rung (one C call per chunk) is pinned
byte-identical to its staged rung, so the staged rung alone gives the same
bytes. Left out with it: the parallel EncodePipeline and its pool, the page
index builder and bloom filters (later slices), and the metrics and trace
hooks.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.arrays import ByteArrayData
from ..core.column_store import PROBE_NA
from ..core.page import encode_data_page_v1, encode_data_page_v2, encode_dict_page
from ..core.stats import column_is_unsigned, compute_statistics
from ..meta.parquet_types import (
    ColumnChunk,
    ColumnMetaData,
    Encoding,
    KeyValue,
    PageEncodingStats,
    PageType,
    RowGroup,
)

__all__ = [
    "EncoderConfig",
    "EncodedChunk",
    "EncodedRowGroup",
    "encode_chunk",
    "assemble_group",
    "commit_group",
]


@dataclass(frozen=True)
class EncoderConfig:
    """The immutable slice of FileWriter configuration a chunk encode needs."""

    codec: int
    data_page_version: int
    max_page_size: int
    with_crc: bool
    column_encodings: dict  # leaf path tuple -> fallback Encoding
    sorting: tuple | None = None  # resolved SortingColumn list (or None)
    write_page_index: bool = False  # per-page statistics: a later slice


@dataclass
class EncodedChunk:
    """One encoded column chunk: page bytes + footer structs with offsets
    relative to the CHUNK start (rebased twice: group stitch, then file)."""

    parts: list  # page byte strings, in file order
    nbytes: int
    chunk: ColumnChunk


@dataclass
class EncodedRowGroup:
    chunks: list  # list[EncodedChunk], leaf order
    row_group: RowGroup
    nbytes: int


def _slice_values(values, a: int, b: int):
    if isinstance(values, ByteArrayData):
        off = values.offsets
        sub = off[a : b + 1] - off[a]
        return ByteArrayData(offsets=sub, data=values.data[off[a] : off[b]])
    return values[a:b]


def _value_width(values) -> int:
    if isinstance(values, ByteArrayData):
        n = len(values)
        return max(int(len(values.data) / n) + 4, 5) if n else 8
    arr = np.asarray(values)
    if arr.ndim == 2:
        return arr.shape[1]
    return max(arr.itemsize, 1)


def _split_starts(n: int, per_page: int):
    """The flat-column page boundaries of _split_pages as (a, b) pairs —
    shared with the device encode path so its page split can never drift
    from the host's."""
    if n == 0:
        yield 0, 0
        return
    if n <= per_page:
        yield 0, n
        return
    starts = list(range(0, n, per_page)) + [n]
    yield from zip(starts[:-1], starts[1:])


def _split_pages(values, def_levels, rep_levels, column, max_page_size: int):
    """Split a chunk into page-sized slices (~max_page_size of value data),
    keeping repeated-value rows intact (page boundaries at rep==0)."""
    n = len(def_levels) if def_levels is not None else len(values)
    if n == 0:
        yield values, def_levels, rep_levels
        return
    per_value = _value_width(values)
    per_page = max(int(max_page_size // max(per_value, 1)), 1)
    if n <= per_page:
        yield values, def_levels, rep_levels
        return
    # candidate boundaries: rows (rep==0) if repeated, else any index
    starts = list(range(0, n, per_page)) + [n]
    if rep_levels is not None and len(rep_levels):
        # Page boundaries must fall on row starts (rep == 0) so a row's
        # repeated values never straddle pages.
        row_starts = np.nonzero(np.asarray(rep_levels) == 0)[0]
        fixed = [0]
        for s in starts[1:-1]:
            k = np.searchsorted(row_starts, s, side="left")
            b = int(row_starts[k]) if k < len(row_starts) else n
            if b > fixed[-1]:
                fixed.append(b)
        if fixed[-1] != n:
            fixed.append(n)
        starts = fixed
    vpos = 0
    for a, b in zip(starts[:-1], starts[1:]):
        if def_levels is not None:
            d_slice = def_levels[a:b]
            nn = int((d_slice == column.max_def).sum())
            v_slice = _slice_values(values, vpos, vpos + nn)
            vpos += nn
        else:
            d_slice = None
            v_slice = _slice_values(values, a, b)
        r_slice = rep_levels[a:b] if rep_levels is not None else None
        yield v_slice, d_slice, r_slice


@dataclass
class _ChunkEncodePlan:
    """Front half of the encode: typed/level normalization and the
    dictionary decision, computed once and read by the page loop (and by
    the device encode, which fills one in from its own probe)."""

    nv: int  # non-null value count
    num_entries: int  # level entries (nulls/empty lists included)
    null_count: int
    def_levels: np.ndarray | None
    rep_levels: np.ndarray | None
    typed: object | None  # None iff the object-domain probe engaged a dict
    dict_result: tuple | None  # (dict_values, indices) | None
    value_encoding: object  # Encoding
    page_values: object  # indices when dict, typed otherwise
    dict_size: int | None
    stats_src: object  # dict_values when dict (same min/max, ~U values)


def _plan_chunk(cfg: EncoderConfig, builder) -> _ChunkEncodePlan:
    column = builder.column
    nv = builder._n_values()
    def_levels = (
        np.asarray(builder.def_levels, dtype=np.uint16)
        if column.max_def > 0
        else None
    )
    rep_levels = (
        np.asarray(builder.rep_levels, dtype=np.uint16)
        if column.max_rep > 0
        else None
    )
    if def_levels is None:
        num_entries = nv
    else:
        num_entries = len(def_levels)
        if builder._columnar_values is not None and len(def_levels) == 0:
            # columnar input for optional column without explicit levels:
            # treat as fully present
            def_levels = np.full(nv, column.max_def, dtype=np.uint16)
            num_entries = nv
    if rep_levels is not None and len(rep_levels) == 0:
        rep_levels = np.zeros(num_entries, dtype=np.uint16)
    null_count = (
        int((def_levels != column.max_def).sum()) if def_levels is not None else 0
    )
    # Dictionary decision. The object-domain probe dedups Python str values
    # BEFORE any UTF-8 materialization; when it rules dictionary encoding
    # out (None) the verdict is definitive and only the typed conversion
    # remains. PROBE_NA falls back to the byte/bit-pattern probes.
    typed = None
    dict_result = builder.fast_dictionary()
    if dict_result is PROBE_NA:
        typed = builder.typed_values()
        dict_result = builder.build_dictionary(typed)
    elif dict_result is None:
        typed = builder.typed_values()
    if dict_result is not None:
        dict_values, indices = dict_result
        value_encoding = Encoding.RLE_DICTIONARY
        page_values = indices
        dict_size = len(dict_values)
        # the dictionary holds exactly the distinct value set: chunk min/max
        # over it equals min/max over the full column at ~U values scanned
        stats_src = dict_values
    else:
        value_encoding = cfg.column_encodings.get(column.path, Encoding.PLAIN)
        page_values = typed
        dict_size = None
        stats_src = typed
    return _ChunkEncodePlan(
        nv=nv,
        num_entries=num_entries,
        null_count=null_count,
        def_levels=def_levels,
        rep_levels=rep_levels,
        typed=typed,
        dict_result=dict_result,
        value_encoding=value_encoding,
        page_values=page_values,
        dict_size=dict_size,
        stats_src=stats_src,
    )


def _chunk_meta(cfg: EncoderConfig, column, kv, plan, *,
                uncompressed_total, pos, data_offset, dict_offset,
                n_pages) -> ColumnChunk:
    """Footer struct of one chunk: ColumnMetaData + statistics, from the
    plan and the page accounting (host or device encode)."""
    encodings = {int(Encoding.RLE)}
    enc_stats: list[PageEncodingStats] = []
    if plan.dict_result is not None:
        encodings.add(int(Encoding.PLAIN))
        encodings.add(int(Encoding.RLE_DICTIONARY))
        enc_stats.append(
            PageEncodingStats(
                page_type=int(PageType.DICTIONARY_PAGE),
                encoding=int(Encoding.PLAIN),
                count=1,
            )
        )
    page_type = (
        int(PageType.DATA_PAGE)
        if cfg.data_page_version == 1
        else int(PageType.DATA_PAGE_V2)
    )
    encodings.add(int(plan.value_encoding))
    enc_stats.append(
        PageEncodingStats(
            page_type=page_type, encoding=int(plan.value_encoding), count=n_pages
        )
    )
    stats = compute_statistics(
        column.type, plan.stats_src, plan.null_count, column_is_unsigned(column)
    )
    if plan.dict_result is not None:
        # the dictionary IS the distinct set: record the exact count
        stats.distinct_count = plan.dict_size
    md = ColumnMetaData(
        type=int(column.type),
        encodings=sorted(encodings),
        path_in_schema=list(column.path),
        codec=cfg.codec,
        num_values=plan.num_entries,
        total_uncompressed_size=uncompressed_total,
        total_compressed_size=pos,
        data_page_offset=data_offset,
        dictionary_page_offset=dict_offset,
        statistics=stats,
        encoding_stats=enc_stats,
        key_value_metadata=(
            [KeyValue(key=k, value=v) for k, v in kv.items()] if kv else None
        ),
    )
    # file_offset: where this chunk's pages begin (parquet-cpp's
    # convention; some readers sanity-check it against the page offsets)
    return ColumnChunk(
        file_offset=dict_offset if dict_offset is not None else data_offset,
        meta_data=md,
    )


def encode_chunk(cfg: EncoderConfig, builder, kv: dict | None) -> EncodedChunk:
    """Encode one buffered column chunk into page bytes + footer structs,
    offsets relative to the chunk start. Pure w.r.t. the writer: the only
    inputs are the frozen config, the builder SNAPSHOT and this flush's KV
    metadata."""
    if cfg.write_page_index:
        raise ValueError("encode_chunk: the page index is not ported yet")
    return _staged_encode_chunk(cfg, builder, kv, _plan_chunk(cfg, builder))


def _staged_encode_chunk(
    cfg: EncoderConfig, builder, kv: dict | None, plan: _ChunkEncodePlan
) -> EncodedChunk:
    """The per-page Python loop over the plan (the JAX module's staged rung,
    the byte oracle of its fused one)."""
    column = builder.column
    parts: list = []
    pos = 0
    uncompressed_total = 0

    def write_page(header, block) -> None:
        nonlocal pos, uncompressed_total
        hdr = header.dumps()
        parts.append(hdr)
        parts.append(block)
        pos += len(hdr) + len(block)
        uncompressed_total += len(hdr) + (header.uncompressed_page_size or 0)

    dict_offset = None
    if plan.dict_result is not None:
        header, block = encode_dict_page(
            column, plan.dict_result[0], cfg.codec, cfg.with_crc
        )
        dict_offset = pos
        write_page(header, block)

    data_offset = pos
    n_pages = 0
    encode_page = encode_data_page_v1 if cfg.data_page_version == 1 else encode_data_page_v2
    for v_slice, d_slice, r_slice in _split_pages(
        plan.page_values, plan.def_levels, plan.rep_levels, column,
        cfg.max_page_size,
    ):
        header, block = encode_page(
            column, v_slice, d_slice, r_slice, plan.value_encoding,
            cfg.codec, plan.dict_size, cfg.with_crc,
        )
        write_page(header, block)
        n_pages += 1
    cc = _chunk_meta(
        cfg,
        column,
        kv,
        plan,
        uncompressed_total=uncompressed_total,
        pos=pos,
        data_offset=data_offset,
        dict_offset=dict_offset,
        n_pages=n_pages,
    )
    return EncodedChunk(parts=parts, nbytes=pos, chunk=cc)


def _shift_chunk(ec: EncodedChunk, delta: int) -> None:
    """Rebase one encoded chunk's offsets by `delta` (group stitch or final
    file placement — the same arithmetic both times)."""
    if delta == 0:
        return
    md = ec.chunk.meta_data
    for attr in ("data_page_offset", "dictionary_page_offset", "index_page_offset"):
        v = getattr(md, attr)
        if v is not None:
            setattr(md, attr, v + delta)
    if ec.chunk.file_offset is not None:
        ec.chunk.file_offset += delta


def assemble_group(
    cfg: EncoderConfig, chunks: list, n_rows: int
) -> EncodedRowGroup:
    """Stitch per-chunk encodes (leaf order) into one row group with offsets
    relative to the GROUP start."""
    base = 0
    total_bytes = 0
    total_compressed = 0
    ccs = []
    for ec in chunks:
        _shift_chunk(ec, base)
        base += ec.nbytes
        ccs.append(ec.chunk)
        md = ec.chunk.meta_data
        total_bytes += md.total_uncompressed_size
        total_compressed += md.total_compressed_size
    first_page_offset = None
    if ccs:
        # file_offset = first page of the group, dictionary page included.
        first_md = ccs[0].meta_data
        first_page_offset = (
            first_md.dictionary_page_offset
            if first_md.dictionary_page_offset is not None
            else first_md.data_page_offset
        )
    rg = RowGroup(
        columns=ccs,
        total_byte_size=total_bytes,
        total_compressed_size=total_compressed,
        num_rows=n_rows,
        file_offset=first_page_offset,
        sorting_columns=list(cfg.sorting) if cfg.sorting else None,
    )
    return EncodedRowGroup(chunks=chunks, row_group=rg, nbytes=base)


def commit_group(erg: EncodedRowGroup, sink, pos: int) -> int:
    """Rebase `erg` to absolute file position `pos` and write its bytes to
    the sink. Returns the new position."""
    for ec in erg.chunks:
        _shift_chunk(ec, pos)  # chunks are group-relative: one shift places all
    if erg.row_group.file_offset is not None:
        erg.row_group.file_offset += pos
    for ec in erg.chunks:
        for part in ec.parts:
            sink.write(part)
    return pos + erg.nbytes
