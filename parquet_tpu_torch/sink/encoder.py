"""Chunk encode and the parallel row-group encode pipeline.

The port's copy of the chunk encoder and its pipeline, with the
reference's observability: a chunk encode is a write.encode stage of the
active trace and an encode_seconds observation, a group commit a
write.flush stage and write_bytes_total{codec=}, and each pipeline group a
flight-recorder record (encode.group); the routing counts go to
write_counts():

  encode_chunk()      one column chunk -> page bytes + metadata with offsets
                      RELATIVE to the chunk start; a pure function of
                      (config, builder snapshot), safe on any thread. Runs
                      the fused -> staged ladder: one GIL-free native call
                      (ptq_chunk_encode, native/encode.cc) for the flat
                      shapes it takes, else the per-page Python loop over
                      core/page.py's encoders, byte-identical to it.
  assemble_group()    stitch encoded chunks into one row group, offsets
                      relative to the GROUP start; gathers the chunks'
                      page indexes and bloom filters.
  commit_group()      rebase a group to its absolute file position and write
                      its bytes to the sink: the one step the serial and
                      parallel writes share, so the two cannot diverge.
  EncodePipeline      the parallel orchestrator: chunk encodes fan out on
                      the "pqt-encode" pool while ONE in-order flusher
                      thread commits finished groups in submission order
                      (output identical to the serial path), with bounded
                      in-flight encoded bytes and faults deferred to the
                      writer's next call.

The page index (_PageIndexBuilder: per-page locations and statistics) and
bloom filters (`bloom_specs`) are built here and written by FileWriter's
tail. The routing counts (write_counts()): device_write_engaged /
device_write_declined (FileWriter.write_device_column), encode_fused_engaged
/ encode_fused_declined / encode_fused_fault_<stage> /
encode_fallback_recovered (this ladder).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from contextvars import copy_context
from dataclasses import dataclass, field

import numpy as np

from ..core.arrays import ByteArrayData
from ..core.column_store import PROBE_NA
from ..core.page import encode_data_page_v1, encode_data_page_v2, encode_dict_page
from ..core.stats import column_is_unsigned, compute_statistics
from ..meta.parquet_types import (
    BoundaryOrder,
    ColumnChunk,
    ColumnIndex,
    ColumnMetaData,
    Encoding,
    KeyValue,
    OffsetIndex,
    PageEncodingStats,
    PageLocation,
    PageType,
    RowGroup,
    Type,
)
from ..obs.log import log_event as _log_event
from ..obs.pool import instrumented_submit
from ..obs.recorder import recorder as _recorder
from ..ops import plain as plain_ops
from ..utils import metrics as _metrics
from ..utils.trace import stage, timed_stage
from .counts import count

__all__ = [
    "EncoderConfig",
    "EncodedChunk",
    "EncodedRowGroup",
    "EncodePipeline",
    "assemble_group",
    "commit_group",
    "encode_chunk",
    "encode_pool",
]

@dataclass(frozen=True)
class EncoderConfig:
    """The immutable slice of FileWriter configuration a chunk encode needs:
    snapshotting it (instead of passing the writer) is what lets encodes run
    on pool threads while the writer keeps accepting columns."""

    codec: int
    data_page_version: int
    max_page_size: int
    with_crc: bool
    column_encodings: dict  # leaf path tuple -> fallback Encoding
    sorting: tuple | None = None  # resolved SortingColumn list (or None)
    write_page_index: bool = False
    bloom_specs: dict = field(default_factory=dict)  # leaf path -> (ndv or None, fpp)


@dataclass
class EncodedChunk:
    """One encoded column chunk: page bytes + footer structs with offsets
    relative to the CHUNK start (rebased twice: group stitch, then file)."""

    parts: list  # page byte strings, in file order
    nbytes: int
    chunk: ColumnChunk
    index: tuple | None = None  # (ColumnIndex, OffsetIndex) when the page index is on
    bloom: object | None = None  # (ColumnMetaData, BloomFilter) awaiting close()


@dataclass
class EncodedRowGroup:
    chunks: list  # list[EncodedChunk], leaf order
    row_group: RowGroup
    nbytes: int
    indexes: list = field(default_factory=list)  # [(cc, ci, oi)]
    blooms: list = field(default_factory=list)  # [(md, bf)]


class _PageIndexBuilder:
    """Accumulates one chunk's per-page locations + statistics into
    (ColumnIndex, OffsetIndex), the Parquet page index."""

    def __init__(self, column, dictionary):
        self.column = column
        self.unsigned = column_is_unsigned(column)
        self.dictionary = dictionary  # dict VALUES when pages carry indices
        self.locations: list[PageLocation] = []
        self.null_pages: list[bool] = []
        self.mins: list[bytes] = []
        self.maxs: list[bytes] = []
        self.null_counts: list[int] = []
        self.first_row = 0
        self.ok = True  # a page without computable stats voids the index

    def add_page(self, offset: int, size: int, v_slice, d_slice, r_slice) -> None:
        if not self.ok:
            return
        if r_slice is not None and len(r_slice):
            rows = int((np.asarray(r_slice) == 0).sum())
        elif d_slice is not None:
            rows = len(d_slice)
        else:
            rows = len(v_slice)
        self.locations.append(
            PageLocation(
                offset=offset, compressed_page_size=size, first_row_index=self.first_row
            )
        )
        self.first_row += rows
        nulls = (
            int((np.asarray(d_slice) != self.column.max_def).sum())
            if d_slice is not None
            else 0
        )
        self.null_counts.append(nulls)
        values = v_slice
        if self.dictionary is not None:
            idx = np.asarray(v_slice)
            values = (
                self.dictionary.take(idx.astype(np.int64))
                if isinstance(self.dictionary, ByteArrayData)
                else np.asarray(self.dictionary)[idx]
            )
        if len(values) == 0:
            self.null_pages.append(True)
            self.mins.append(b"")
            self.maxs.append(b"")
            return
        st = compute_statistics(self.column.type, values, nulls, self.unsigned)
        if st.min_value is None or st.max_value is None:
            # all-NaN page / oversized binary: a legal index can't represent
            # it, so write no index for this chunk at all
            self.ok = False
            return
        self.null_pages.append(False)
        self.mins.append(st.min_value)
        self.maxs.append(st.max_value)

    def _boundary_order(self) -> int:
        # the tables that packed these exact bytes
        from ..core.stats import _PACK, _PACK_UNSIGNED
        from ..meta.parquet_types import ConvertedType

        unpack = (
            _PACK_UNSIGNED.get(self.column.type)
            if self.unsigned
            else _PACK.get(self.column.type)
        )
        if unpack is None:
            if self.column.type in (Type.BYTE_ARRAY, Type.FIXED_LEN_BYTE_ARRAY):
                ct = self.column.converted_type
                lt = self.column.logical_type
                if ct in (ConvertedType.DECIMAL, ConvertedType.INTERVAL) or (
                    lt is not None
                    and (lt.DECIMAL is not None or lt.FLOAT16 is not None)
                ):
                    # signed / no defined order: lexicographic bytes would
                    # mislead a reader's binary search
                    return int(BoundaryOrder.UNORDERED)
                # unsigned lexicographic IS the defined order for binary
                # columns, and it's how these bounds were computed - sorted
                # string columns keep readers' binary search
                unpack = None
            else:
                return int(BoundaryOrder.UNORDERED)  # INT96 etc.: stay safe
        if unpack is None:
            pairs = [
                (mn, mx)
                for mn, mx, null in zip(self.mins, self.maxs, self.null_pages)
                if not null
            ]
        else:
            pairs = [
                (unpack.unpack(mn)[0], unpack.unpack(mx)[0])
                for mn, mx, null in zip(self.mins, self.maxs, self.null_pages)
                if not null
            ]
        if len(pairs) < 2:
            return int(BoundaryOrder.ASCENDING)
        if all(
            b[0] >= a[0] and b[1] >= a[1] for a, b in zip(pairs, pairs[1:])
        ):
            return int(BoundaryOrder.ASCENDING)
        if all(
            b[0] <= a[0] and b[1] <= a[1] for a, b in zip(pairs, pairs[1:])
        ):
            return int(BoundaryOrder.DESCENDING)
        return int(BoundaryOrder.UNORDERED)

    def build(self):
        if not self.ok:
            return ()
        ci = ColumnIndex(
            null_pages=self.null_pages,
            min_values=self.mins,
            max_values=self.maxs,
            boundary_order=self._boundary_order(),
            null_counts=self.null_counts,
        )
        oi = OffsetIndex(page_locations=self.locations)
        return (ci, oi)


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
    """The flat-column page boundaries of _split_pages as (a, b) pairs -
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
                n_pages) -> tuple:
    """Footer structs of one chunk: ColumnMetaData + statistics and the
    bloom filter, from the plan and the page accounting (host or device
    encode)."""
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
    bloom = None
    spec = cfg.bloom_specs.get(column.path)
    if spec is not None:
        hash_src = (
            plan.dict_result[0] if plan.dict_result is not None else plan.typed
        )
        if len(hash_src):
            from ..core.bloom import BloomFilter, bloom_hash_values

            ndv, fpp = spec
            bf = BloomFilter.sized_for(ndv or len(hash_src), fpp)
            bf.insert_hashes(bloom_hash_values(column.type, hash_src))
            bloom = (md, bf)
    # file_offset: where this chunk's pages begin (parquet-cpp's
    # convention; some readers sanity-check it against the page offsets)
    cc = ColumnChunk(
        file_offset=dict_offset if dict_offset is not None else data_offset,
        meta_data=md,
    )
    return cc, bloom


def encode_chunk(cfg: EncoderConfig, builder, kv: dict | None) -> EncodedChunk:
    """Encode one buffered column chunk into page bytes + footer structs,
    offsets relative to the chunk start. Pure w.r.t. the writer: the only
    inputs are the frozen config, the builder SNAPSHOT and this flush's KV
    metadata.

    Runs the fused -> staged encode ladder (the write-side mirror of the
    prepare ladder in kernels/pipeline.py): one GIL-free native call
    (ptq_chunk_encode) does page split + level pack + value encode +
    compress + Thrift framing for the flat shapes it takes, byte-identical
    to the staged per-page Python loop, which stays the rung for everything
    else and the error-semantics oracle. PQT_FUSED_ENCODE=0 forces the
    staged rung; the outcome is counted in write_counts()
    (encode_fused_engaged / encode_fused_declined /
    encode_fallback_recovered)."""
    with timed_stage("write.encode", record_span=True) as clock:
        plan = _plan_chunk(cfg, builder)
        fault = None
        ec = _fused_encode_chunk(cfg, builder, kv, plan)
        if ec is not None and not isinstance(ec, EncodedChunk):
            fault, ec = ec, None  # EncodeFault: remember for the recovery count
        if ec is None:
            ec = _staged_encode_chunk(cfg, builder, kv, plan)
            if fault is not None:
                # the staged rung salvaged a chunk the native walk refused
                count("encode_fallback_recovered")
                _log_event(
                    "encode_fallback_recovered",
                    level="warning",
                    column=builder.column.path_str,
                    stage=fault.stage,
                    code=fault.code,
                    page=fault.page,
                )
    _metrics.observe("encode_seconds", clock.seconds)
    return ec


# codecs the native encode walk inlines (they must also still resolve to
# the stock implementation: core.compress.is_fused_encode_codec checks both)
_FUSED_ENCODE_CODECS = (0, 1, 2)


def _fused_encode_chunk(cfg: EncoderConfig, builder, kv, plan):
    """The native rung: returns an EncodedChunk, an EncodeFault (walk ran
    and aborted - the caller retries staged and counts the recovery), or
    None (declined: shape/codec/config outside the fused envelope, or the
    escape hatch is set)."""
    if os.environ.get("PQT_FUSED_ENCODE", "1") == "0":
        return None  # forced staged path: not a decline, no counter
    from ..utils.native import delta_encode_cap, get_native, hybrid_encode_cap

    lib = get_native()
    column = builder.column
    if column.max_rep > 0 or cfg.write_page_index:
        # nested page splits / per-page index stats are staged-only shapes
        count("encode_fused_declined")
        return None
    from ..core.compress import is_fused_encode_codec

    if cfg.codec not in _FUSED_ENCODE_CODECS or not is_fused_encode_codec(
        cfg.codec
    ):
        count("encode_fused_declined")
        return None

    ba_offsets = None
    dict_raw = None
    dict_width = 0
    dict_num = 0
    if plan.dict_result is not None:
        from ..ops.bitpack import bit_width

        dict_values = plan.dict_result[0]
        values_buf = np.ascontiguousarray(plan.dict_result[1], dtype=np.uint32)
        route = 2
        type_size = 4
        per_value = 4
        dict_width = bit_width(max(plan.dict_size - 1, 0))
        dict_num = plan.dict_size
        try:
            dict_raw = plain_ops.encode_plain(
                dict_values, column.type, column.type_length
            )
        except Exception:
            count("encode_fused_declined")
            return None
        values_worst = 1 + hybrid_encode_cap(plan.nv, dict_width)
    else:
        typed = plan.typed
        enc = plan.value_encoding
        if enc == Encoding.PLAIN and isinstance(typed, ByteArrayData):
            route = 1
            type_size = 0
            values_buf = typed.data
            ba_offsets = np.ascontiguousarray(typed.offsets, dtype=np.int64)
            n = plan.nv
            per_value = max(int(len(typed.data) / n) + 4, 5) if n else 8
            values_worst = len(typed.data) + 4 * n + 16
        elif (
            enc == Encoding.PLAIN
            and isinstance(typed, np.ndarray)
            and typed.ndim == 1
            and typed.dtype.kind in "iuf"
            and typed.itemsize in (4, 8)
        ):
            route = 0
            values_buf = np.ascontiguousarray(typed)
            type_size = per_value = typed.itemsize
            values_worst = values_buf.nbytes + 16
        elif (
            enc == Encoding.PLAIN
            and isinstance(typed, np.ndarray)
            and typed.ndim == 2
            and typed.dtype == np.uint8
            and 1 <= typed.shape[1] <= 4096
        ):
            # FIXED_LEN_BYTE_ARRAY / INT96: PLAIN is a row-major memcpy
            route = 0
            values_buf = np.ascontiguousarray(typed)
            type_size = per_value = typed.shape[1]
            values_worst = values_buf.nbytes + 16
        elif (
            enc == Encoding.DELTA_BINARY_PACKED
            and isinstance(typed, np.ndarray)
            and typed.ndim == 1
            and typed.dtype in (np.dtype(np.int32), np.dtype(np.int64))
        ):
            route = 3
            values_buf = np.ascontiguousarray(typed)
            type_size = per_value = typed.itemsize
            values_worst = delta_encode_cap(plan.nv, type_size * 8)
        elif (
            enc == Encoding.RLE
            and column.type == Type.BOOLEAN
            and isinstance(typed, np.ndarray)
            and typed.ndim == 1
        ):
            # RLE-boolean: width-1 hybrid stream behind a 4-byte prefix.
            # per_value stays the STAGED path's _value_width (the 1-byte
            # bool element) so page splits cannot drift; the native walk
            # reads the values as uint16 like the level packer.
            route = 4
            values_buf = np.ascontiguousarray(typed, dtype=np.uint16)
            type_size = 2
            per_value = 1
            pages_est = plan.nv // max(int(cfg.max_page_size), 1) + 2
            values_worst = (
                hybrid_encode_cap(plan.nv, 1) + 96 * pages_est
            )
        else:
            # BOOLEAN bit-packing, BYTE_STREAM_SPLIT, DELTA_*_BYTE_ARRAY
            # and exotic inputs stay on the staged rung
            count("encode_fused_declined")
            return None

    per_page = max(int(cfg.max_page_size // max(per_value, 1)), 1)
    levels_worst = 0
    if column.max_def > 0:
        from ..ops.bitpack import bit_width

        levels_worst = 4 + hybrid_encode_cap(
            plan.num_entries, bit_width(column.max_def)
        )
    res = lib.chunk_encode(
        route,
        values_buf,
        ba_offsets,
        plan.nv,
        type_size,
        dict_width,
        dict_raw,
        dict_num,
        plan.def_levels if column.max_def > 0 else None,
        plan.num_entries,
        column.max_def,
        int(cfg.codec),
        cfg.data_page_version,
        cfg.with_crc,
        per_page,
        values_worst + levels_worst + 64,
    )
    if not isinstance(res, dict):
        count("encode_fused_declined")
        count(f"encode_fused_fault_{res.stage}")
        return res  # EncodeFault: the caller runs the staged rung + counters
    count("encode_fused_engaged")
    totals = res["totals"]
    n_pages = int(totals[2])
    dict_offset = int(totals[3]) if int(totals[3]) >= 0 else None
    data_offset = int(totals[4])
    pos = int(totals[0])
    cc, bloom = _chunk_meta(
        cfg,
        column,
        kv,
        plan,
        uncompressed_total=int(totals[1]),
        pos=pos,
        data_offset=data_offset,
        dict_offset=dict_offset,
        n_pages=n_pages,
    )
    # bytes-like part, not the ndarray itself: sinks concatenate parts into
    # bytearrays/files, and an ndarray would be swallowed by numpy's
    # arithmetic overloads instead. The slice VIEW pins the whole
    # worst-case-sized staging buffer until the group commits, so when
    # compression left significant slack (the common gzip/snappy case)
    # copy out exactly the encoded bytes - the parallel pipeline's
    # in-flight window then holds encoded sizes, not capacities.
    out = res["out"]
    if out.base is not None and out.base.nbytes > pos + pos // 4 + 4096:
        part = out.tobytes()
    else:
        part = memoryview(out)
    return EncodedChunk(
        parts=[part], nbytes=pos, chunk=cc, index=None, bloom=bloom
    )


def _staged_encode_chunk(
    cfg: EncoderConfig, builder, kv: dict | None, plan: _ChunkEncodePlan
) -> EncodedChunk:
    """The staged rung: the per-page Python loop over the shared plan, the
    byte oracle of the fused rung and the path every shape outside the
    fused envelope takes."""
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
        dict_values = plan.dict_result[0]
        header, block = encode_dict_page(
            column, dict_values, cfg.codec, cfg.with_crc
        )
        dict_offset = pos
        write_page(header, block)

    data_offset = pos
    n_pages = 0
    encode_page = encode_data_page_v1 if cfg.data_page_version == 1 else encode_data_page_v2
    index = (
        _PageIndexBuilder(
            column, plan.dict_result[0] if plan.dict_result else None
        )
        if cfg.write_page_index
        else None
    )
    for v_slice, d_slice, r_slice in _split_pages(
        plan.page_values, plan.def_levels, plan.rep_levels, column,
        cfg.max_page_size,
    ):
        page_offset = pos
        header, block = encode_page(
            column, v_slice, d_slice, r_slice, plan.value_encoding,
            cfg.codec, plan.dict_size, cfg.with_crc,
        )
        write_page(header, block)
        if index is not None:
            index.add_page(
                page_offset, pos - page_offset, v_slice, d_slice, r_slice
            )
        n_pages += 1
    cc, bloom = _chunk_meta(
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
    built = index.build() if index is not None else None
    return EncodedChunk(
        parts=parts, nbytes=pos, chunk=cc, index=built or None, bloom=bloom
    )


def _shift_chunk(ec: EncodedChunk, delta: int) -> None:
    """Rebase one encoded chunk's offsets by `delta` (group stitch or final
    file placement - the same arithmetic both times)."""
    if delta == 0:
        return
    md = ec.chunk.meta_data
    for attr in ("data_page_offset", "dictionary_page_offset", "index_page_offset"):
        v = getattr(md, attr)
        if v is not None:
            setattr(md, attr, v + delta)
    if ec.chunk.file_offset is not None:
        ec.chunk.file_offset += delta
    if ec.index:
        for loc in ec.index[1].page_locations:
            loc.offset += delta


def assemble_group(
    cfg: EncoderConfig, chunks: list, n_rows: int
) -> EncodedRowGroup:
    """Stitch per-chunk encodes (leaf order) into one row group with offsets
    relative to the GROUP start."""
    base = 0
    total_bytes = 0
    total_compressed = 0
    ccs = []
    indexes = []
    blooms = []
    for ec in chunks:
        _shift_chunk(ec, base)
        base += ec.nbytes
        ccs.append(ec.chunk)
        md = ec.chunk.meta_data
        total_bytes += md.total_uncompressed_size
        total_compressed += md.total_compressed_size
        if cfg.write_page_index and ec.index:
            indexes.append((ec.chunk, *ec.index))
        if ec.bloom is not None:
            blooms.append(ec.bloom)
    first_md = ccs[0].meta_data if ccs else None
    first_page_offset = None
    if first_md is not None:
        # file_offset = first page of the group, dictionary page included.
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
    return EncodedRowGroup(
        chunks=chunks,
        row_group=rg,
        nbytes=base,
        indexes=indexes,
        blooms=blooms,
    )


def commit_group(erg: EncodedRowGroup, sink, pos: int, codec_label: str) -> int:
    """Rebase `erg` to absolute file position `pos` and write its bytes to
    the sink. Returns the new position. The ONE place group bytes meet the
    sink: serial and parallel writes are byte-identical because they both
    end here, in submission order. `codec_label` labels the group's
    write_bytes_total{codec=} sample."""
    for ec in erg.chunks:
        _shift_chunk(ec, pos)  # chunks are group-relative: one shift places all
    if erg.row_group.file_offset is not None:
        erg.row_group.file_offset += pos
    with stage("write.flush", erg.nbytes):
        for ec in erg.chunks:
            for part in ec.parts:
                sink.write(part)
    _metrics.inc("write_bytes_total", erg.nbytes, codec=codec_label)
    return pos + erg.nbytes


# -- the dedicated encode pool -------------------------------------------------

_pool: ThreadPoolExecutor | None = None
_pool_lock = threading.Lock()


def encode_pool() -> ThreadPoolExecutor:
    """The process-wide parallel-encode executor ("pqt-encode",
    min(cpu, 8) workers; a writer that wants another size passes
    parallel=N). Deliberately its OWN pool: encode tasks are CPU-bound
    native/numpy work, and parking them in the prepare, io or dataset pools
    would let a heavy write starve reads (or deadlock a pool waiting on work
    it must itself run)."""
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = ThreadPoolExecutor(
                max_workers=min(os.cpu_count() or 1, 8), thread_name_prefix="pqt-encode"
            )
        return _pool


class EncodePipeline:
    """Per-writer parallel encode + in-order flush orchestrator.

    submit() fans one row group's chunk encodes out on the pool (every chunk
    an independent task - intra-group AND inter-group parallelism with no
    nested submission, so the pool can never deadlock on itself) and hands
    the ordered future list to the single flusher thread, which assembles,
    rebases and commits finished groups to the sink STRICTLY in submission
    order - the file's bytes are identical to the serial path's.

    Backpressure: submit() blocks while the estimated in-flight encoded
    bytes exceed `max_inflight_bytes` (at least one group is always
    admitted, so a group larger than the budget still makes progress).

    Faults (encode or flush) are captured, the queue is drained without
    writing further groups, and the error re-raises from the next submit()/
    drain() - the writer surfaces it as a typed WriterError. After an error
    the pipeline never writes another byte (abort semantics are the sink's:
    an atomic sink leaves no torn file)."""

    def __init__(
        self,
        cfg: EncoderConfig,
        sink,
        start_pos: int,
        *,
        pool: ThreadPoolExecutor,
        max_inflight_bytes: int = 256 << 20,
    ):
        self.cfg = cfg
        self.sink = sink
        self.pos = start_pos
        self.pool = pool
        self.max_inflight_bytes = int(max_inflight_bytes)
        self.row_groups: list[RowGroup] = []
        self.page_indexes: list[list] = []  # per committed group, when enabled
        self.blooms: list = []  # (md, bf) in file order
        self.error: BaseException | None = None
        self._codec_label = _metrics.codec_name(cfg.codec)
        self._lock = threading.Lock()
        self._have_work = threading.Condition(self._lock)
        self._room = threading.Condition(self._lock)
        self._queue: deque = deque()  # (chunk_futures, n_rows, est_bytes)
        self._inflight_bytes = 0
        self._inflight_groups = 0
        self._stopping = False
        self._thread: threading.Thread | None = None

    # -- producer side (writer thread) -----------------------------------------

    def submit(self, builders: list, kvs: list, n_rows: int, est_bytes: int) -> None:
        """Fan out one row group's chunk encodes (builders in leaf order,
        kvs aligned) and queue it for in-order commit. Blocks for
        backpressure; raises the captured pipeline error if one is set."""
        with self._lock:
            self._raise_pending()
            while (
                self._inflight_groups > 0
                and self._inflight_bytes + est_bytes > self.max_inflight_bytes
            ):
                self._room.wait()
                self._raise_pending()
        # ONE context snapshot per group, shared as a template by every
        # chunk task: the group's chunks all carry the same trace and tenant
        group_ctx = copy_context()
        futs = [
            instrumented_submit(
                self.pool, encode_chunk, self.cfg, b, kv,
                pool="pqt-encode", ctx=group_ctx,
            )
            for b, kv in zip(builders, kvs)
        ]
        with self._lock:
            self._queue.append((futs, n_rows, est_bytes))
            self._inflight_bytes += est_bytes
            self._inflight_groups += 1
            if self._thread is None:
                # the flusher carries the submitting context (an active
                # decode_trace at the first flush keeps collecting its spans)
                self._thread = threading.Thread(
                    target=copy_context().run, args=(self._run,),
                    name="pqt-flush", daemon=True,
                )
                self._thread.start()
            self._have_work.notify()

    def _raise_pending(self) -> None:
        # caller holds self._lock
        if self.error is not None:
            raise self.error

    # -- consumer side (the one flusher thread) --------------------------------

    def _run(self) -> None:
        while True:
            with self._lock:
                while not self._queue and not self._stopping:
                    self._have_work.wait()
                if not self._queue:
                    return  # stopping and drained
                futs, n_rows, est = self._queue.popleft()
            try:
                if self.error is None:
                    t0 = time.perf_counter()
                    chunks = [f.result() for f in futs]
                    erg = assemble_group(self.cfg, chunks, n_rows)
                    ordinal = erg.row_group.ordinal = len(self.row_groups)
                    pos0 = self.pos
                    self.pos = commit_group(erg, self.sink, self.pos, self._codec_label)
                    self.row_groups.append(erg.row_group)
                    if self.cfg.write_page_index:
                        self.page_indexes.append(erg.indexes)
                    self.blooms.extend(erg.blooms)
                    # the library side of the flight recorder: encode groups
                    # land in the ring the serve daemon's /v1/debug lists
                    _recorder().record(
                        "encode.group",
                        duration_s=time.perf_counter() - t0,
                        nbytes=self.pos - pos0,
                        detail={"group": ordinal, "rows": n_rows},
                    )
                else:
                    for f in futs:  # error set: drop, but don't leak workers
                        f.cancel()
            except BaseException as e:  # noqa: BLE001 (deferred to the writer)
                _log_event(
                    "encode_group_failed", level="error",
                    group=len(self.row_groups), error=f"{type(e).__name__}: {e}",
                )
                _recorder().record(
                    "encode.group", status="error",
                    detail={"group": len(self.row_groups), "rows": n_rows},
                    error=e,
                )
                with self._lock:
                    if self.error is None:
                        self.error = e
            finally:
                with self._lock:
                    self._inflight_bytes -= est
                    self._inflight_groups -= 1
                    self._room.notify_all()

    # -- lifecycle -------------------------------------------------------------

    def drain(self) -> None:
        """Block until every submitted group is committed; re-raise the
        pipeline error if any group failed."""
        with self._lock:
            self._stopping = True
            self._have_work.notify_all()
            t = self._thread
        if t is not None:
            t.join()
        with self._lock:
            self._raise_pending()

    def abort(self) -> None:
        """Stop without committing queued groups (their encodes are dropped).
        Never raises - abort is the error path."""
        from .sink import SinkError

        with self._lock:
            if self.error is None:
                self.error = SinkError("write pipeline aborted")  # poison
            self._stopping = True
            self._have_work.notify_all()
            t = self._thread
        if t is not None:
            t.join()
