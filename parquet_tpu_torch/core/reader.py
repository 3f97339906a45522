"""FileReader: footer, column selection, and row-group decode on the host or
into device memory.

A subset of parquet_tpu.core.reader.FileReader. The backends:

  "host"              read_row_group decodes on the host (core.chunk).
  "device"            the same; device delivery is read_row_group_device.
  "device_roundtrip"  read_row_group forces device decode and a fetch: the
                      parity oracle against the host decode.

read_row_group_device / read_row_groups_device decode straight into device
memory on every backend, and iter_device_batches streams the file as
fixed-size batches of device tensors (MaskedColumn for nullable columns,
RaggedColumn for padded LIST columns).

Threads and streams, as in the reference: every chunk's host prepare (the
fused native walk, one C call with the GIL dropped) is submitted up front
to the "pqt-host" pool (_host_pool, PQT_HOST_THREADS workers, default
min(cpu count, 16); 0 or 1 prepares serially on the calling thread), and
its uploads and launches are queued, in (group, column) order as each
prepare resolves, on the "pqt-dispatch" thread, which runs them on a CUDA
stream of its own (kernels/pipeline.dispatch_pool, dispatch_stream).
device_column() runs on the calling thread: its current stream waits on
the plan's event before it touches a dispatched tensor, and what it
launches itself (the dictionary gather, the merges, the BYTE_STREAM_SPLIT
transpose, the batch layer's kernels) goes to that stream.

Filters (pyarrow-style (column, op, value) conjunctions, or an OR of them)
prune row groups by their statistics and bloom filters
(prune_row_groups), evaluate as a device row mask over a group's
delivered columns (read_row_group_device(filters=), core/filter_device,
with the host vec engine as its typed and counted fallback), and compact
a batch stream on the device (iter_device_batches(filters=,
filter_rows=True)). filter_counts() reads the plain counters of that path.
Within a group, the page index (read_page_index) narrows a filter to the
row ranges whose pages may match (prune_pages).

Rows: iter_rows (and iterating the reader) yields each row as a dict of
Python values, assembled on the host from the host decode of each group
(core/assembly_vec.py's level scans, or the scalar Dremel walk of
core/assembly.py where the scans cannot prove the shape; PQT_VEC_ASSEMBLY=0
forces the walk). iter_rows(filters=) prunes groups by statistics and bloom
filters, narrows each group to the page index's row ranges (decoding only
those pages when they cover few rows: selective page decode), evaluates
the predicate as one host row mask (core/filter_vec; PQT_VEC_FILTER=0, or a
predicate the mask declines, takes the scalar row_matches walk) and
assembles only the kept rows. Which engine ran shows in row_counts(). Row
reads touch no device, whatever the reader's `device`.

Bytes: every byte goes through a ByteSource (io.source.open_source): a path
opens a LocalFileSource (os.pread, no lock shared by the prepare threads),
an http(s):// URL an io.remote.HttpSource, bytes and file objects adapt.
The host read fetches a group's chunks in one planned, coalesced batch
(io.planner.fetch_ranges; `coalesce_gap`, "auto" tunes it per transport),
the device prepare one chunk at a time; both go through `block_cache`
when one is attached, and `footer_cache` spares the footer parse of a file
seen before. `max_memory` caps what one row group decodes to
(core.alloc.AllocError past it), `compact_levels` delivers the levels
bit-packed (ops.packed_levels), and `on_error` ("skip" / "null")
quarantines corrupt chunks on the host read and the row path, counted in
io.counts (chunks_quarantined, chunks_nulled, row_groups_quarantined);
device delivery always raises.

The device is explicit: `device=None` means `torch.device("cuda")`, and a
reader built without a device on a machine with no CUDA raises rather than
decoding on the CPU. Pass `device="cpu"` to run the kernels' plain PyTorch
versions on the CPU.
"""

from __future__ import annotations

import gc
import itertools
import os
import threading
from collections import Counter
from concurrent.futures import ThreadPoolExecutor, wait
from contextlib import contextmanager
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from ..io.counts import count as _io_count
from ..io.planner import DEFAULT_COALESCE_GAP, fetch_ranges
from ..io.source import LocalFileSource, SourceFile, open_source
from ..kernels.device_ops import expand_nullable, mask_take_rows, mask_take_scan, pad_ragged
from ..kernels.pipeline import (
    DecodeStats,
    DeviceColumn,
    dispatch,
    mark_pool_thread,
    on_pool_thread,
    prepare_chunk_plan,
    to_device,
)
from ..meta.file_meta import ParquetFileError, read_file_metadata
from ..meta.parquet_types import (
    BloomFilterHeader,
    ColumnIndex,
    FieldRepetitionType,
    FileMetaData,
    OffsetIndex,
    RowGroup,
    Type,
)
from ..meta.thrift import CompactReader, ThriftError
from ..ops.packed_levels import PackedLevels
from ..utils.native import get_native
from .alloc import AllocTracker
from .arrays import ByteArrayData
from .assembly import RecordAssembler
from .assembly_vec import _zip_dict_rows, assemble_row_columns, vec_enabled
from .bloom import BloomFilter
from .chunk import (
    ChunkData,
    ChunkError,
    ChunkWindow,
    _empty_dtype,
    chunk_byte_range,
    read_chunk,
    read_chunk_row_ranges,
)
from .filter import (
    FilterError,
    chunks_by_path,
    dnf_group_may_match,
    dnf_page_ranges,
    dnf_row_matches,
    normalize_dnf,
    row_group_may_match,
)
from .filter_device import DeviceFilterError, device_dnf_mask
from .filter_vec import (
    VecFilterError,
    dnf_mask,
    group_row_count,
    masked_flat_columns,
    vec_filter_enabled,
)
from .page import PageError
from .schema import Schema
from .stats import column_is_unsigned

__all__ = [
    "FileReader",
    "BACKENDS",
    "PARQUET_ERRORS",
    "MaskedColumn",
    "RaggedColumn",
    "filter_counts",
    "reset_filter_counts",
    "reset_row_counts",
    "resolve_device",
    "row_counts",
]

BACKENDS = ("host", "device", "device_roundtrip")
ON_ERROR = ("raise", "skip", "null")

# The typed malformed-file error family: everything a corrupt or lying file
# can raise out of a read (the reference's PARQUET_ERRORS).
PARQUET_ERRORS = (ParquetFileError, ChunkError, PageError, ThriftError)

_pool: ThreadPoolExecutor | None = None
_pool_lock = threading.Lock()


def _host_pool() -> ThreadPoolExecutor | None:
    """The shared "pqt-host" pool of the host prepare phase, or None when
    prepare runs serially on the calling thread. Sized by PQT_HOST_THREADS
    (default min(cpu count, 16); 0 or 1 means serial, with dispatch still on
    its own thread). The fused walk runs a whole chunk in one C call with
    the GIL dropped, so N workers give up to N cores of the walk; the NumPy
    assembly around it holds the GIL. The pool is made once, at the size the
    first parallel read asked for."""
    global _pool
    env = os.environ.get("PQT_HOST_THREADS")
    workers = int(env) if env else min(os.cpu_count() or 1, 16)
    if workers <= 1:
        return None
    with _pool_lock:
        if _pool is None:
            _pool = ThreadPoolExecutor(
                max_workers=workers, thread_name_prefix="pqt-host", initializer=mark_pool_thread
            )
        return _pool

# -- filter counters ---------------------------------------------------------------
#
# The counters the JAX package bumps through utils.trace on its filter path:
# device_filter_engaged / device_filter_declined (a group's row mask from
# the device engine, or from the host vec engine after a typed decline),
# and groups_pruned_stats / groups_pruned_bloom (row groups the pruning walk
# excluded, by the rung that excluded them). Process-wide, like the prepare
# counters: read with filter_counts(), zero with reset_filter_counts().

_FILTER_COUNTS: Counter = Counter()
_FILTER_LOCK = threading.Lock()


def _bump(name: str, n: int = 1) -> None:
    with _FILTER_LOCK:
        _FILTER_COUNTS[name] += n


def filter_counts() -> dict:
    """A snapshot of the filter counters."""
    with _FILTER_LOCK:
        return dict(_FILTER_COUNTS)


def reset_filter_counts() -> None:
    with _FILTER_LOCK:
        _FILTER_COUNTS.clear()


# -- row counters ------------------------------------------------------------------
#
# The engines of the row path, which the JAX package bumps as trace events
# and metrics: assemble_vec / assemble_cursor (a group's rows from the
# vectorized engine or the scalar Dremel walk), selective_page_decode (a
# group decoded from the page index's admitted pages only), rows_filtered_vec
# / rows_filtered_scalar (rows iter_rows(filters=) dropped, by the engine
# that evaluated the predicate), rows_assembled_vec / rows_assembled_scalar
# (rows delivered, by engine). Process-wide: read with row_counts(), zero
# with reset_row_counts().

_ROW_COUNTS: Counter = Counter()
_ROW_LOCK = threading.Lock()


def _count_rows(name: str, n: int = 1) -> None:
    with _ROW_LOCK:
        _ROW_COUNTS[name] += n


def row_counts() -> dict:
    """A snapshot of the row counters."""
    with _ROW_LOCK:
        return dict(_ROW_COUNTS)


def reset_row_counts() -> None:
    with _ROW_LOCK:
        _ROW_COUNTS.clear()


def _timed_rows(assembler):
    """Stream rows from the scalar cursor walk without materializing the row
    group, counting each delivered row (rows_assembled_scalar) when the
    stream ends or the consumer abandons it."""
    n = 0
    try:
        for row in assembler:
            n += 1
            yield row
    finally:
        _count_rows("rows_assembled_scalar", n)


# Rows materialize in windows this size: cyclic GC cost scales with LIVE
# tracked containers, so bounded windows keep collections cheap while
# consumers that drop rows as they go (aggregations, filters) never hold a
# whole 1M-row group of dicts.
_ASSEMBLE_WINDOW = 1 << 16


@contextmanager
def _gc_paused():
    """Pause cyclic GC around a bulk container build: each incremental
    collection re-scans the still-growing result (~25% of assembly wall
    time) and nothing in row assembly creates reference cycles."""
    was_enabled = gc.isenabled()
    if was_enabled:
        gc.disable()
    try:
        yield
    finally:
        if was_enabled:
            gc.enable()


def resolve_device(device=None) -> torch.device:
    """The device a reader delivers to: `device`, or CUDA when it is None.
    Raises when CUDA is asked for (or defaulted to) and is not available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "parquet_tpu_torch: CUDA is not available; pass device=\"cpu\" to "
            "decode with the kernels' plain versions on the CPU"
        )
    return dev


def _dispatch_prepared(prepared, device):
    """Dispatch-thread task: the chunk plan a prepare future gives, uploaded
    and launched on the dispatch stream (a prepare error re-raises here, at
    the caller's result())."""
    return prepared.result().dispatch_device(device)


def _settle(staged) -> None:
    """Wait for every future of a staged read, failed ones included, so no
    prepare or dispatch of a read that raised or was abandoned outlives it
    (their counters and buffers belong to that read). On a thread of the
    port's own pools (a dropped stream finalized there by the garbage
    collector) it returns at once: the futures may be queued behind that
    very thread, and they finish on their own."""
    if on_pool_thread():
        return
    wait([fut for group in staged for _path, fut in group])


def resolve_column_prefixes(schema: Schema, columns):
    """Each entry of `columns` is a dotted (or tuple) path prefix selecting
    every leaf under it. Returns the selected leaf path set (None = all)."""
    if columns is None:
        return None
    selected = set()
    for c in columns:
        path = tuple(c.split(".")) if isinstance(c, str) else tuple(c)
        hits = [leaf.path for leaf in schema.leaves if leaf.path[: len(path)] == path]
        if not hits:
            raise ParquetFileError(f"parquet: selected column {c!r} not in schema")
        selected.update(hits)
    return selected


class RaggedColumn(NamedTuple):
    """A single-level LIST column in device-batch form: `values` are the
    rows' elements padded to a fixed [rows, max_len] matrix (zero past each
    row's length), `lengths` the per-row element count (null and empty
    lists both have length 0). The lengths keep the dtype of the host
    count, as in the reference: int64 (NumPy's reduceat of int32 flags), or
    int32 for a group with no rows."""

    values: torch.Tensor  # [rows, max_len] of the element dtype
    lengths: torch.Tensor  # [rows] int64 (int32 when empty)


def _pad_ragged_device(values, lengths, max_len: int) -> RaggedColumn:
    """Pad a flat element vector into [rows, max_len] on the device
    (device_ops.pad_ragged): row offsets from a scan of the lengths, each row
    gathers its slice, slots past the row's length zero-fill."""
    return RaggedColumn(values=pad_ragged(values, lengths, max_len), lengths=lengths)


class MaskedColumn(NamedTuple):
    """A nullable column in device-batch form: `values` are row-aligned with
    null rows zero-filled on the device; `mask` is True where the row is
    non-null (bool). A step takes the pair and computes e.g.
    `torch.where(col.mask, col.values, fill)`."""

    values: torch.Tensor  # [n] of the column dtype
    mask: torch.Tensor  # [n] bool


def _expand_nullable_device(values, mask) -> MaskedColumn:
    """Scatter the dense non-null values into row positions on the device
    (device_ops.expand_nullable), nulls zero-filled."""
    return MaskedColumn(values=expand_nullable(values, mask), mask=mask)


def _tree_map(fn, tree: dict, *rest: dict) -> dict:
    """fn over every tensor of {path: Tensor | MaskedColumn | RaggedColumn}
    (and the same paths and fields of `rest`), keeping the structure."""
    out = {}
    for path, node in tree.items():
        others = [r[path] for r in rest]
        if isinstance(node, tuple):
            out[path] = type(node)(*(fn(*fields) for fields in zip(node, *others)))
        else:
            out[path] = fn(node, *others)
    return out


def _tree_leaves(tree: dict) -> list:
    return [t for node in tree.values() for t in (node if isinstance(node, tuple) else (node,))]


def _shard_batches(batches, rank: int, world: int):
    """Each batch's rows of this rank: the contiguous 1/world slice of a
    batch; a short final batch that world does not divide goes whole to
    rank 0 (empty elsewhere)."""
    for batch in batches:
        n = _tree_leaves(batch)[0].shape[0]
        if n % world == 0:
            lo, hi = rank * (n // world), (rank + 1) * (n // world)
        else:
            lo, hi = (0, n) if rank == 0 else (0, 0)
        yield _tree_map(lambda a, lo=lo, hi=hi: a[lo:hi], batch)


class FileReader:
    """Reads Parquet files into host ChunkData or device DeviceColumns.

    Usage:
        with FileReader("file.parquet") as r:           # delivers to CUDA
            groups = r.read_row_groups_device()        # [{path: DeviceColumn}]
    """

    def __init__(
        self,
        source,
        columns=None,
        *,
        backend: str = "host",
        device=None,
        validate_crc: bool = False,
        metadata: FileMetaData | None = None,
        schema: Schema | None = None,
        max_memory: int | None = None,
        compact_levels: bool = False,
        on_error: str = "raise",
        block_cache=None,
        footer_cache=None,
        coalesce_gap=None,
    ):
        """`metadata=` reuses a footer already parsed (open_metadata) and
        `schema=` a Schema already built for it: the dataset layer opens one
        reader a row group, and neither parses again.

        `max_memory` caps the bytes one row group decodes to (advertised
        page sizes are checked before decompression, decoded buffers are
        charged as they materialize; core.alloc.AllocError past it).
        `compact_levels=True` delivers the R/D levels of read_row_group and
        the device reads bit-packed (ops.packed_levels.PackedLevels).
        `on_error` is the host read's corruption policy: "raise" (the
        default), "skip" (a corrupt chunk drops its whole row group) or
        "null" (a corrupt chunk of an optional column delivers as all-null;
        a required one drops the group). Device delivery always raises.
        `block_cache` (io.cache.BlockCache or io.tiercache.TieredCache)
        serves chunk bytes read before; `footer_cache` (io.cache.FooterCache)
        serves the footer of a path or URL whose generation is unchanged;
        `coalesce_gap` is the host read's merge gap in bytes (None: 64 KiB;
        "auto": the io.autotune profile of the source's transport). It
        applies only to the host read (read_row_group with backend="host",
        iter_rows and the dataset's loads, which fetch a group's chunks in
        one planned batch): the device prepare and the device round trip
        fetch one chunk per request, whatever the gap."""
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}: expected one of {BACKENDS}")
        if on_error not in ON_ERROR:
            raise ValueError(
                f"unknown on_error {on_error!r}: expected 'raise', 'skip', or 'null'"
            )
        self.device = resolve_device(device)
        self.backend = backend
        self.validate_crc = validate_crc
        self.alloc = AllocTracker(max_memory) if max_memory else None
        self.compact_levels = compact_levels
        self.on_error = on_error
        self._block_cache = block_cache
        if coalesce_gap is None:
            self._coalesce_gap = DEFAULT_COALESCE_GAP
        elif coalesce_gap == "auto":
            self._coalesce_gap = "auto"
        else:
            self._coalesce_gap = int(coalesce_gap)
        # page routing counts of every device plan this reader made
        self.stats = DecodeStats()
        self._bloom_cache: dict = {}
        # every byte comes through the source; self._f is a stream-shaped
        # cursor over it for the footer parse, and the chunk reads are
        # positional (_fetch_chunk, _chunk_windows)
        self._source, self._owns_file = open_source(source)
        self._f = SourceFile(self._source)
        try:
            if metadata is not None:
                self.metadata: FileMetaData = metadata
            else:
                path_key = str(source) if isinstance(source, (str, Path)) else None
                # URL keys can't os.stat: validate against the remote
                # source's generation (size, ETag) instead
                gen = self._source.generation() if path_key is not None else None
                cached = (
                    footer_cache.get(path_key, sig=gen)
                    if footer_cache is not None and path_key is not None
                    else None
                )
                if cached is not None:
                    self.metadata = cached
                else:
                    self.metadata = read_file_metadata(self._f)
                    if footer_cache is not None and path_key is not None:
                        footer_cache.put(path_key, self.metadata, sig=gen)
            self.schema = schema if schema is not None else Schema.from_thrift(self.metadata.schema)
            self._selected = resolve_column_prefixes(self.schema, columns)
        except BaseException:
            self.close()
            raise

    @classmethod
    def open_metadata(cls, path, footer_cache=None) -> FileMetaData:
        """Parse only the footer of `path`: no data page is read and no
        handle survives the call (the dataset's planning primitive).
        `footer_cache` (io.cache.FooterCache) makes the parse once a file
        generation: a warm hit reads nothing. `path` may be an http(s)://
        URL; the cache then validates against its (size, ETag)."""
        if isinstance(path, str) and path.startswith(("http://", "https://")):
            src, owns = open_source(path)
            try:
                gen = src.generation()
                if footer_cache is not None:
                    meta = footer_cache.get(path, sig=gen)
                    if meta is not None:
                        return meta
                meta = read_file_metadata(SourceFile(src))
                if footer_cache is not None:
                    footer_cache.put(path, meta, sig=gen)
                return meta
            finally:
                if owns:
                    src.close()
        if footer_cache is not None:
            meta = footer_cache.get(path)
            if meta is not None:
                return meta
        with LocalFileSource(path) as src:
            meta = read_file_metadata(SourceFile(src))
        if footer_cache is not None:
            footer_cache.put(path, meta)
        return meta

    @classmethod
    def open_many(cls, paths, columns=None, **options) -> "list[FileReader]":
        """Open several files at once (footers only). All or nothing: when
        one open fails, the readers already open are closed before the
        error propagates. Every option goes to each reader."""
        readers: list[FileReader] = []
        try:
            for p in paths:
                readers.append(cls(p, columns=columns, **options))
        except BaseException:
            for r in readers:
                r.close()
            raise
        return readers

    # -- properties ------------------------------------------------------------

    @property
    def num_rows(self) -> int:
        return self.metadata.num_rows or 0

    @property
    def num_row_groups(self) -> int:
        return len(self.metadata.row_groups or [])

    @property
    def created_by(self) -> str | None:
        return self.metadata.created_by

    @property
    def key_value_metadata(self) -> dict[str, str | None]:
        return {
            kv.key: kv.value for kv in (self.metadata.key_value_metadata or [])
        }

    def row_group(self, i: int) -> RowGroup:
        groups = self.metadata.row_groups or []
        if not 0 <= i < len(groups):
            raise IndexError(f"row group {i} out of range (file has {len(groups)})")
        return groups[i]

    def set_selected_columns(self, *columns) -> None:
        self._selected = resolve_column_prefixes(self.schema, columns or None)

    # -- chunk access ----------------------------------------------------------

    def _selected_chunks(self, i: int, columns=None):
        """Yield (path, ColumnChunk, Column) for the selected leaves of group i."""
        selected = (
            resolve_column_prefixes(self.schema, columns) if columns else self._selected
        )
        rg = self.row_group(i)
        if self.alloc is not None:
            self.alloc.release()  # the ceiling is a row group's
        for cc in rg.columns or []:
            md = cc.meta_data
            if md is None:
                raise ParquetFileError("parquet: column chunk without metadata")
            path = tuple(md.path_in_schema or [])
            if selected is not None and path not in selected:
                continue
            yield path, cc, self.schema.column(path)

    def _window(self, cc) -> ChunkWindow:
        """One chunk's page bytes in one read (the device prepare's). A
        range past the end of the file reads short, and the page walk raises
        its typed error."""
        offset, total = chunk_byte_range(cc)
        return ChunkWindow(self._fetch_chunk(offset, total), offset)

    def _pread(self, offset: int, size: int) -> bytes:
        """Positional read through the reader's source: os.pread on local
        files, so no shared cursor and no lock. Clamps at EOF (a short
        return, like a plain handle): truncated files surface as the decode
        ladder's typed errors, not a raw source exception."""
        end = self._source.size()
        if offset >= end or offset < 0 or size <= 0:
            return b""
        return self._source.read_at(offset, min(size, end - offset))

    def _fetch_chunk(self, offset: int, size: int):
        """One chunk's page bytes, through the block cache when attached.
        Out-of-bounds or degenerate ranges (truncated or lying files) bypass
        the cache and return short via _pread, so corruption keeps its typed
        decode error."""
        if size <= 0 or offset < 0 or offset + size > self._source.size():
            return self._pread(offset, size)
        if self._block_cache is None:
            return self._source.read_at(offset, size)
        return fetch_ranges(
            self._source, [(offset, size)], cache=self._block_cache, gap=0
        )[(offset, size)]

    def _chunk_windows(self, selected) -> "dict | None":
        """The host read's batched fetch of the selected chunks: exact
        extents from the footer, neighbours coalesced into batched source
        reads (io.planner.fetch_ranges), each chunk handed back as a
        ChunkWindow. None when the planner path does not apply: memory-
        ceiling readers (preloading a whole group would hold every page at
        once) and chunks whose ranges are unusable or out of bounds (the
        per-chunk read then raises the precise typed error)."""
        if self.alloc is not None or not selected:
            return None
        ranges = {}
        end = self._source.size()
        for path, cc, _col in selected:
            try:
                off, total = chunk_byte_range(cc)
            except ChunkError:
                return None
            # total == 0 included: coalesce() drops empty ranges, so the
            # fetch would come back without the key
            if off < 0 or total <= 0 or off + total > end:
                return None
            ranges[path] = (off, total)
        fetched = fetch_ranges(
            self._source,
            list(ranges.values()),
            cache=self._block_cache,
            gap=self._coalesce_gap,
        )
        return {path: ChunkWindow(fetched[r], r[0]) for path, r in ranges.items()}

    # -- host delivery ---------------------------------------------------------

    def _pack_chunk_levels(self, path, delivered):
        """Swap a delivered ChunkData/DeviceColumn's level arrays for their
        bit-packed form (the compact_levels contract)."""
        if not self.compact_levels or delivered is None:
            return delivered
        col = self.schema.column(path)
        dl, rl = delivered.def_levels, delivered.rep_levels
        if dl is not None and not isinstance(dl, PackedLevels):
            delivered.def_levels = PackedLevels.from_array(dl, col.max_def)
        if rl is not None and not isinstance(rl, PackedLevels):
            delivered.rep_levels = PackedLevels.from_array(rl, col.max_rep)
        return delivered

    def read_row_group(self, i: int, columns=None) -> dict[tuple, ChunkData]:
        """Decode one row group into {leaf path: ChunkData}. On the host, or
        with backend="device_roundtrip" through the device and back. Under
        on_error != "raise" a corrupt chunk is quarantined (see __init__);
        a dropped group returns {}."""
        return self._read_row_group(i, columns, pack=True)

    def _read_row_group(self, i: int, columns, pack: bool) -> dict[tuple, ChunkData]:
        """pack=False is the internal path of rows and masks: they consume
        the levels at once, so bit-packing them would be a round trip."""
        if self.backend == "device_roundtrip":
            try:
                plans = self._plan_row_group(i, columns, self.device)
                out = {path: plan.finalize() for path, plan in plans.items()}
            except PARQUET_ERRORS:
                # chunks plan and finalize as a batch here, so isolation is
                # a group's on this backend
                if self.on_error == "raise":
                    raise
                _io_count("chunks_quarantined")
                _io_count("row_groups_quarantined")
                return {}
        else:
            out = self._read_host(i, columns)
        if pack and self.compact_levels:
            for path, cd in out.items():
                self._pack_chunk_levels(path, cd)
        return out

    def _read_host(self, i: int, columns) -> dict[tuple, ChunkData]:
        """The host decode of group i's selected chunks, under on_error.
        The chunks come in one planned fetch (_chunk_windows), or chunk by
        chunk where that does not apply."""
        out = {}
        selected = list(self._selected_chunks(i, columns))
        windows = self._chunk_windows(selected)
        for path, cc, column in selected:
            try:
                # inside the try: a lying footer range (chunk_byte_range's
                # ChunkError) is a corrupt chunk like any other
                f = windows[path] if windows is not None else self._window(cc)
                out[path] = read_chunk(
                    f, cc, column, validate_crc=self.validate_crc, alloc=self.alloc
                )
            except PARQUET_ERRORS:
                if self.on_error == "raise":
                    raise
                _io_count("chunks_quarantined")
                if self.on_error == "null":
                    nc = self._null_chunk(i, column)
                    if nc is not None:
                        _io_count("chunks_nulled")
                        out[path] = nc
                        continue
                # the columns of a group stay row-aligned: one chunk that
                # cannot be delivered drops the group
                _io_count("row_groups_quarantined")
                return {}
        return out

    def _null_chunk(self, i: int, column) -> "ChunkData | None":
        """An all-null stand-in for a quarantined chunk (on_error='null'):
        one level entry per row at definition 0. Only possible when the
        column is optional somewhere along its path (max_def > 0): a
        REQUIRED column has no null representation, so the caller
        quarantines the group."""
        if column.max_def <= 0:
            return None
        rows = self.row_group(i).num_rows or 0
        if column.type == Type.BYTE_ARRAY:
            values = ByteArrayData(offsets=np.zeros(1, dtype=np.int64), data=b"")
        elif column.type == Type.FIXED_LEN_BYTE_ARRAY:
            values = np.empty((0, column.type_length or 0), dtype=np.uint8)
        elif column.type == Type.INT96:
            values = np.empty((0, 12), dtype=np.uint8)
        else:
            values = np.empty(0, dtype=_empty_dtype(column))
        return ChunkData(
            column=column,
            num_values=rows,
            values=values,
            def_levels=np.zeros(rows, dtype=np.uint16),
            rep_levels=np.zeros(rows, dtype=np.uint16) if column.max_rep > 0 else None,
        )

    # -- host rows ---------------------------------------------------------------

    def iter_rows(self, row_groups=None, raw: bool = False, filters=None):
        """Yield rows as dicts (returns an iterator). `raw=True` gives
        reference-style nested maps (no LIST/MAP unwrapping, bytes not
        decoded). `filters` is a flat list of (column, op, value) triples (a
        conjunction) or a list of LISTS of triples (an OR of conjunctions —
        pyarrow's DNF convention): row groups whose statistics/bloom/
        page-index exclude the predicate are skipped wholesale and the
        surviving rows are predicate-checked exactly. Rows are built on the
        host; no device is touched."""
        if filters is None and row_groups is None and self.num_row_groups == 1:
            # single-group scan: hand back the group's list/generator with
            # no extra per-row generator hop
            rows = self._iter_group_rows(0, raw)
            return iter(rows) if isinstance(rows, list) else rows
        return self._iter_rows_gen(row_groups, raw, filters)

    def _iter_rows_gen(self, row_groups, raw: bool, filters):
        dnf = None
        if filters is not None:
            if raw:
                # row_matches compares in the converted domain (datetime,
                # Decimal, str); raw rows are wire-shaped (ints, undecoded
                # bytes, nested wrappers), so the predicate would silently
                # mismatch — mirror floor.Reader, which only prunes for the
                # unmarshal path
                raise FilterError("filters cannot be combined with raw=True")
            dnf = normalize_dnf(self.schema, filters)
        # Filter columns OUTSIDE the projection still evaluate: decode them
        # alongside the selection, predicate-check, then strip them from the
        # yielded rows (silently returning zero rows because the predicate
        # column was projected out is a correctness trap). Stripping is
        # LEAF-granular: each missing leaf is deleted at the shallowest
        # path component no selected leaf shares, so g.c vanishes from a
        # row that keeps g.b, and a whole unselected root vanishes outright.
        read_cols = None
        strips: list = []  # (parent path parts, key to pop)
        if dnf is not None and self._selected is not None:
            fpaths = {p for conj in dnf for p, *_ in conj}
            missing = fpaths - self._selected
            if missing:
                read_cols = list(self._selected | fpaths)
                for path in missing:
                    cut = 1
                    while cut < len(path) and any(
                        sel[:cut] == path[:cut] for sel in self._selected
                    ):
                        cut += 1
                    strips.append((path[: cut - 1], path[cut - 1]))
        indices = range(self.num_row_groups) if row_groups is None else row_groups
        for i in indices:
            if dnf is None:
                yield from self._iter_group_rows(i, raw)
                continue
            if not dnf_group_may_match(self.row_group(i), dnf, self._bloom_excludes, i):
                continue
            # page index (when written): restrict row materialization to the
            # ranges whose pages may match — row assembly is the dominant
            # cost of a filtered scan, so pruned ranges never build rows
            ranges = None
            indexes = None
            try:
                # one parse covers both uses: range computation here and
                # selective page decode in _read_group_ranges. Filter columns
                # outside the projection still prune, so their index is
                # fetched alongside the selected columns'.
                indexes = self.read_page_index(i, columns=read_cols)
                if any(ci is not None for ci, _ in indexes.values()):
                    num_rows = self.row_group(i).num_rows or 0
                    ranges = dnf_page_ranges(dnf, indexes, num_rows)
                    if ranges == [(0, num_rows)]:
                        # nothing pruned: keep the unpruned fast paths
                        ranges = None
            except ParquetFileError:
                ranges = None  # corrupt index: scan everything, stay correct
                indexes = None
            if ranges is not None and not ranges:
                continue
            yield from self._filtered_group_rows(i, raw, dnf, ranges, indexes, read_cols, strips)

    def _filtered_group_rows(self, i: int, raw: bool, dnf, ranges, indexes, read_cols, strips):
        """One row group's rows surviving the residual predicate.

        The vectorized path: the decoded chunks compile into ONE boolean
        row mask (core/filter_vec.dnf_mask — per-leaf masks over the
        columnar buffers, AND within conjunctions, OR across them) and only
        matching rows ever materialize. Shapes or value domains the mask
        pipeline cannot prove raise the typed VecFilterError and this falls
        back to the scalar per-row `row_matches` walk — identical output
        (PQT_VEC_FILTER=0 forces the scalar walk)."""
        chunks, sliced = self._decode_group_chunks(i, ranges, indexes, read_cols)
        if not chunks:
            return  # quarantined group (on_error='skip'), or empty selection
        mask = None
        if vec_filter_enabled() and vec_enabled():
            try:
                mask = dnf_mask(chunks, dnf, group_row_count(chunks))
            except VecFilterError:
                mask = None
        if mask is not None:
            kept = int(mask.sum())
            if not kept:
                # the mask alone proved the group empty of matches: no rows
                # assemble under either engine, the filtering was vec's
                _count_rows("rows_filtered_vec", len(mask))
                return
            # rows assemble from the PROJECTION only: filter-only leaf
            # chunks never build row values, so the strip pass the scalar
            # path needs does not exist here
            row_chunks = (
                chunks
                if self._selected is None
                else {p: cd for p, cd in chunks.items() if p in self._selected}
            )
            # flat schemas gather ONLY the kept rows (value boxing and
            # logical conversion scale with matches, not group size)
            try:
                flat = masked_flat_columns(row_chunks, raw, mask)
            except VecFilterError:
                flat = None
            if flat is not None:
                _count_rows("assemble_vec")
                _count_rows("rows_filtered_vec", len(mask) - kept)
                names, columns, k = flat
                if names and k:
                    yield from self._column_rows(names, columns, k)
                return
            with _gc_paused():
                rc = assemble_row_columns(self.schema, row_chunks, raw)
            if rc is not None and rc[2] == len(mask):
                _count_rows("assemble_vec")
                _count_rows("rows_filtered_vec", len(mask) - kept)
                names, columns, _n = rc
                if names:
                    yield from self._masked_rows(names, columns, mask)
                return
            # row assembly couldn't prove the shape: the scalar walk below
            # decides (and raises its precise error on real inconsistency);
            # the filtered rows are counted THERE, never here too
        evaluated = kept = 0
        try:
            for row in self._rows_from_chunks(chunks, raw, ranges, sliced):
                evaluated += 1
                if not dnf_row_matches(row, dnf):
                    continue
                kept += 1
                for parents, key in strips:
                    d = row
                    for part in parents:
                        d = d.get(part) if isinstance(d, dict) else None
                        if d is None:
                            break
                    if isinstance(d, dict):
                        d.pop(key, None)
                yield row
        finally:
            _count_rows("rows_filtered_scalar", evaluated - kept)

    def _decode_group_chunks(self, i: int, ranges, indexes, columns):
        """(chunks, sliced) for one row group: selective page decode when
        the page index proves `ranges` (sorted disjoint row windows) cover
        few enough rows, else the full decode. sliced=True means the chunks
        hold exactly the ranges' rows."""
        chunks = None
        if ranges is not None:
            try:
                chunks = self._read_group_ranges(i, ranges, indexes, columns)
            except ValueError:
                # inconsistent index, or a page shape the range decoder
                # does not cover (ChunkError/PageError/...): the full decode
                # below stays correct and raises the precise error if the
                # file is genuinely corrupt
                chunks = None
        sliced = chunks is not None
        if sliced:
            _count_rows("selective_page_decode")
        else:
            chunks = self._read_row_group(i, columns, pack=False)
        return chunks, sliced

    def _iter_group_rows(self, i: int, raw: bool, ranges=None, indexes=None, columns=None):
        """One row group's rows: a LIST for small vectorized shapes (callers
        iterate without an extra generator frame per row), a window-batched
        generator for large ones (bounds the live tracked-object count so
        cyclic GC passes stay cheap), or the streaming Dremel fallback."""
        chunks, sliced = self._decode_group_chunks(i, ranges, indexes, columns)
        if not chunks:
            return []  # quarantined group (on_error='skip'), or empty selection
        return self._rows_from_chunks(chunks, raw, ranges, sliced)

    def _rows_from_chunks(self, chunks: dict, raw: bool, ranges=None, sliced=False):
        rc = None
        if vec_enabled():
            # the vectorized engine: level prefix scans -> offsets/validity
            # columns (core/assembly_vec.py). None when the scans cannot
            # prove the shape, or always when PQT_VEC_ASSEMBLY=0.
            with _gc_paused():
                rc = assemble_row_columns(self.schema, chunks, raw)
            if rc is not None:
                _count_rows("assemble_vec")
        if rc is None:
            # per-row Dremel fallback: streams one row at a time (constant
            # memory) and raises precise errors on inconsistent level data
            _count_rows("assemble_cursor")
            return _timed_rows(RecordAssembler(self.schema, chunks, raw=raw, engine="scalar"))
        names, columns, n = rc
        if not names or n == 0:
            return []
        if ranges is not None and not sliced:
            # full decode happened: restrict materialization to the ranges
            return self._ranged_rows(names, columns, ranges)
        if n <= _ASSEMBLE_WINDOW:
            with _gc_paused():
                rows = _zip_dict_rows(names, columns)
            _count_rows("rows_assembled_vec", n)
            return rows
        return self._ranged_rows(names, columns, [(0, n)])

    def _read_group_ranges(self, i: int, ranges, indexes=None, columns=None) -> dict | None:
        """Selective page decode of row group i restricted to `ranges`, or
        None when it does not apply (no/partial offset index, repeated
        columns, or ranges covering most rows — whole-chunk decode wins
        then). All returned chunks hold exactly the ranges' rows, aligned.
        `indexes` reuses an already-parsed page index for this group."""
        num_rows = self.row_group(i).num_rows or 0
        covered = sum(e - s for s, e in ranges)
        if num_rows == 0 or covered * 4 > num_rows * 3:
            return None
        selected = list(self._selected_chunks(i, columns))
        if any(col.max_rep > 0 for _, _, col in selected):
            return None
        if indexes is None:
            indexes = self.read_page_index(i, columns=columns)
        out = {}
        for path, cc, col in selected:
            oi = indexes.get(path, (None, None))[1]
            if oi is None or not oi.page_locations:
                return None
            firsts = [loc.first_row_index for loc in oi.page_locations]
            if (
                any(not isinstance(x, int) for x in firsts)
                or firsts[0] != 0
                or any(b <= a for a, b in zip(firsts, firsts[1:]))
                or any(
                    not isinstance(loc.offset, int) or loc.offset <= 0
                    for loc in oi.page_locations
                )
            ):
                return None  # foreign/corrupt index: full decode
            out[path] = read_chunk_row_ranges(
                SourceFile(self._source), cc, col, oi, ranges, num_rows,
                validate_crc=self.validate_crc, alloc=self.alloc,
            )
        return out

    @staticmethod
    def _column_rows(names, columns, n):
        """Row dicts from already-gathered column value lists, windowed to
        bound live tracked objects like every other materialization path."""

        def windows():
            for s in range(0, n, _ASSEMBLE_WINDOW):
                e = min(s + _ASSEMBLE_WINDOW, n)
                with _gc_paused():
                    rows = _zip_dict_rows(names, [c[s:e] for c in columns])
                _count_rows("rows_assembled_vec", e - s)
                yield rows

        return itertools.chain.from_iterable(windows())

    @staticmethod
    def _masked_rows(names, columns, mask):
        """Materialize only the rows a boolean mask keeps, windowed like
        _ranged_rows. One itertools.compress pass per window gathers
        arbitrary (even per-row fragmented) masks at C speed."""
        n = len(mask)

        def windows():
            for s in range(0, n, _ASSEMBLE_WINDOW):
                e = min(s + _ASSEMBLE_WINDOW, n)
                wm = mask[s:e]
                k = int(wm.sum())
                if not k:
                    continue
                with _gc_paused():
                    if k == e - s:
                        cols = [c[s:e] for c in columns]
                    else:
                        wml = wm.tolist()
                        cols = [list(itertools.compress(c[s:e], wml)) for c in columns]
                    rows = _zip_dict_rows(names, cols)
                _count_rows("rows_assembled_vec", k)
                yield rows

        return itertools.chain.from_iterable(windows())

    @staticmethod
    def _ranged_rows(names, columns, ranges):
        # chain.from_iterable over window LISTS: the per-row next() is pure
        # C (no Python generator frame resumes per row); the Python frame
        # below only wakes once per 64Ki-row window
        def windows():
            for start, stop in ranges:
                for s in range(start, stop, _ASSEMBLE_WINDOW):
                    e = min(s + _ASSEMBLE_WINDOW, stop)
                    # build INSIDE the GC pause, yield OUTSIDE it: the
                    # consumer must run with GC enabled
                    with _gc_paused():
                        rows = _zip_dict_rows(names, [c[s:e] for c in columns])
                    _count_rows("rows_assembled_vec", e - s)
                    yield rows

        return itertools.chain.from_iterable(windows())

    def iter_row_groups(self, columns=None):
        for i in range(self.num_row_groups):
            yield self.read_row_group(i, columns=columns)

    def __iter__(self):
        """Iterating the reader yields rows — the `for reader.NextRow()` loop
        of the reference (file_reader.go:258) as a Python iterator."""
        return self.iter_rows()

    # -- device delivery -------------------------------------------------------

    def _plan_row_groups_async(self, indices, columns, device) -> list:
        """Stage the chunks of several row groups at once: every chunk's
        prepare is submitted to the host pool up front (no barrier between
        groups), and its dispatch is queued on the dispatch thread in
        (group, column) order, each dispatch task taking its chunk's plan
        as the prepare resolves. Returns [[(path, future of the dispatched
        plan)]] a group, unresolved. With no pool the prepares run here, in
        order, and each dispatch still overlaps the next prepare."""
        groups = [list(self._selected_chunks(i, columns)) for i in indices]

        def prep(cc, column):
            return prepare_chunk_plan(
                self._window(cc), cc, column, validate_crc=self.validate_crc,
                alloc=self.alloc, stats=self.stats,
            )

        pool = _host_pool()
        if pool is None or sum(len(g) for g in groups) <= 1:
            staged: list = []
            try:
                for chunks in groups:
                    staged.append([])
                    for path, cc, column in chunks:
                        plan = prep(cc, column)
                        staged[-1].append((path, dispatch(plan.dispatch_device, device, device)))
            except BaseException:
                _settle(staged)
                raise
            return staged
        get_native()  # the host library's lazy init, before the fan-out
        return [
            [(path, dispatch(_dispatch_prepared, device, pool.submit(prep, cc, column), device))
             for path, cc, column in chunks]
            for chunks in groups
        ]

    def _plan_row_group(self, i: int, columns, device) -> dict:
        """Every selected chunk of group i prepared and dispatched: {leaf
        path: dispatched plan}."""
        staged = self._plan_row_groups_async([i], columns, device)
        try:
            return {path: fut.result() for path, fut in staged[0]}
        except BaseException:
            _settle(staged)
            raise

    def read_row_group_device(self, i: int, columns=None, device=None, *, filters=None):
        """Decode one row group straight into device memory: {leaf path:
        DeviceColumn}. `device` overrides the reader's device for this call.

        `filters` (a (column, op, value) conjunction, or a list of lists:
        the OR-of-ANDs DNF convention) additionally evaluates the predicate
        over the delivered columns and returns ({leaf path: DeviceColumn},
        mask), the mask a bool[num_rows] tensor computed on the device
        (core/filter_device; the host vec engine takes over, typed and
        counted, for any shape the device engine declines). Any filter
        column missing from `columns` is read and delivered too. The
        columns are NOT compacted: feed the mask to
        kernels.device_ops.mask_take for the gather, or carry it into
        masked reductions."""
        dev = self.device if device is None else resolve_device(device)
        if filters is None:
            plans = self._plan_row_group(i, columns, dev)
            return {
                path: self._pack_chunk_levels(path, plan.device_column())
                for path, plan in plans.items()
            }
        normalized = normalize_dnf(self.schema, filters)
        plans = self._plan_row_group(i, self._columns_with_filters(columns, normalized), dev)
        cols = {path: plan.device_column() for path, plan in plans.items()}
        n = int(self.row_group(i).num_rows or 0)
        mask = self._device_group_mask(i, cols, normalized, n, dev)
        return {p: self._pack_chunk_levels(p, dc) for p, dc in cols.items()}, mask

    def _columns_with_filters(self, columns, normalized):
        """The read set a row-filtered device read needs: the caller's
        projection plus any filter-referenced leaf it misses (None = all
        columns, which already covers every filter leaf)."""
        if columns is None:
            return None
        proj = resolve_column_prefixes(self.schema, columns)
        fpaths = {e[0] for conj in normalized for e in conj}
        return sorted(proj) + sorted(p for p in fpaths if p not in proj)

    def _device_group_mask(self, i, group, normalized, n, dev, *, null_mode="row"):
        """bool[n] DEVICE row mask for group i's delivered columns — the
        engine ladder: the device kernels (filter_device.device_dnf_mask)
        first; a typed decline counts device_filter_declined and derives the
        mask with the host vec engine, uploaded (a shape even it declines
        raises its typed VecFilterError). Anything else, a CUDA error
        included, propagates."""
        try:
            mask = device_dnf_mask(group, normalized, n, null_mode=null_mode, device=dev)
        except DeviceFilterError:
            _bump("device_filter_declined")
            return to_device(self._host_row_mask(i, normalized, n, null_mode), dev)
        _bump("device_filter_engaged")
        return mask

    def _host_row_mask(self, i, normalized, n, null_mode="row"):
        """Host-engine fallback mask: decode the filter columns on the host
        and run the vec mask pipeline (np bool[n])."""
        cols = sorted({e[0] for conj in normalized for e in conj})
        if not cols:
            return dnf_mask({}, normalized, n, null_mode=null_mode)
        chunks = self._read_row_group(i, cols, pack=False)
        if not chunks:
            # quarantined under an on_error policy: no rows to admit
            return np.zeros(n, dtype=bool)
        return dnf_mask(chunks, normalized, n, null_mode=null_mode)

    def _device_filter_rows(self, i, group, normalized, arrs, n, dev):
        """Row-level compaction of one staged group (iter_device_batches
        filter_rows=True): DNF -> device mask (_device_group_mask, with its
        typed and counted host fallback) -> ONE mask_take scan shared by
        every delivered leaf, then one row gather per tensor into exactly
        the kept rows. The kept count is the group's one host sync.
        Returns (filtered arrs, kept rows)."""
        mask = self._device_group_mask(i, group, normalized, n, dev)
        src, count = mask_take_scan(mask, n)
        kept = int(count)
        if kept == n or kept == 0:
            return arrs, kept
        return _tree_map(lambda a: mask_take_rows(a, src, count, kept), arrs), kept

    def read_row_groups_device(
        self, row_groups=None, columns=None, device=None
    ) -> list[dict[tuple, DeviceColumn]]:
        """Decode row groups into device memory, in row-group order. Every
        chunk of every group is staged before the first is delivered
        (_plan_row_groups_async): the prepares run on the host pool, the
        uploads and launches queue back to back on the dispatch stream, and
        group i's delivery on this thread overlaps the later groups'."""
        dev = self.device if device is None else resolve_device(device)
        indices = range(self.num_row_groups) if row_groups is None else row_groups
        if self.alloc is not None:
            # the ceiling is a row group's (released between groups):
            # staging several at once would charge them all together, so
            # a capped reader stages one group at a time
            return [self.read_row_group_device(i, columns, device=dev) for i in indices]
        staged = self._plan_row_groups_async(list(indices), columns, dev)
        try:
            return [
                {
                    path: self._pack_chunk_levels(path, fut.result().device_column())
                    for path, fut in group
                }
                for group in staged
            ]
        except BaseException:
            _settle(staged)
            raise

    # -- fixed-size device batches ------------------------------------------------

    def iter_device_batches(
        self,
        batch_size: int,
        columns=None,
        drop_remainder: bool = True,
        nullable: str = "error",
        lists: str = "error",
        max_list_len: int | None = None,
        device=None,
        filters=None,
        filter_rows: bool = False,
        sharding=None,
    ):
        """Stream the file as fixed-size device-resident batches.

        Each yielded batch is {leaf path: torch.Tensor} with exactly
        `batch_size` rows, values already decoded on the device.
        Dictionary-encoded byte-array columns yield their int32 indices
        (embedding-lookup style). Unsupported shapes raise: raw and merged
        byte-array columns (no device array form) and repeated columns
        (leaf slots are not rows) unless `lists="pad"`; project them out with
        `columns=`.

        `nullable` picks the policy for columns with nulls:
          "error" (default)  raise: non-null cells would silently shift rows
          "mask"             yield MaskedColumn(values, mask): values
                             row-aligned with nulls zero-filled on the device,
                             mask a bool row validity tensor. An optional
                             column stays a MaskedColumn in groups without
                             nulls, so every batch has the same structure.

        `lists` picks the policy for single-level LIST columns:
          "error" (default)  raise: leaf slots are not rows
          "pad"              yield RaggedColumn(values, lengths): values
                             row-padded on the device to [rows, max_list_len]
                             (zero past each row's length), lengths the
                             per-row element count. Requires max_list_len; a
                             row longer than it raises, as do null elements
                             inside a list. Null and empty lists both have
                             length 0.

        Batches are row slices of each row group's tensors (concatenated with
        the rows carried over from the previous group): views, not copies, so
        a batch keeps its group's tensors alive and an in-place write to a
        batch writes through to them. While the consumer runs on group i's
        batches, group i+1 prepares on the host pool and dispatches on the
        dispatch stream (one-group lookahead, held as futures): memory stays
        bounded by two row groups plus the carry.
        With drop_remainder=False the final short batch is yielded as is.

        `filters` pushes a predicate (a (column, op, value) conjunction, or
        a list of lists: the OR-of-ANDs DNF convention) down to ROW-GROUP
        granularity: groups whose statistics or bloom filters exclude it
        are never prepared, uploaded or decoded (counted as
        groups_pruned_stats / groups_pruned_bloom). Surviving groups stream
        whole: rows are not filtered one by one.

        `filter_rows=True` (requires `filters`) extends the push-down to
        ROW granularity on the device: each surviving group's predicate
        evaluates as a device mask over the resident columns
        (core/filter_device) and one mask_take scan compacts every leaf to
        the matching rows, which pack densely across group boundaries. A
        predicate shape the device engine cannot run falls back, typed and
        counted (device_filter_engaged / device_filter_declined), to the
        host vec engine's mask with the same compaction. Filter columns
        missing from `columns=` are read for the mask but not batched.

        `device` overrides the reader's device for every batch. The uploads
        and decode launches run on the dispatch stream; a batch is safe on
        the calling thread's current stream, which waits on each group's
        events, and the batch layer's own launches go to that stream.

        `sharding` (a torch.distributed ProcessGroup, or a DeviceMesh, whose
        ranks it flattens) splits every batch over the group's ranks, as the
        reference's jax.device_put(batch, NamedSharding(mesh, P(axes))) does
        with every mesh axis in P: rank k
        yields rows [k*b/w, (k+1)*b/w) of each global batch (w the group's
        size, b the batch size, which w must divide), with a MaskedColumn's
        values and mask sliced together. Every rank reads the whole stream
        (the carry between row groups stays global), so rank k's slices
        concatenate to the unsharded stream. A final short batch that w
        does not divide is not split: rank 0 yields it whole and the others
        an empty slice, so every rank takes the same number of steps.
        """
        if batch_size <= 0:
            raise ValueError("batch_size must be positive")
        if nullable not in ("error", "mask"):
            raise ValueError('nullable must be "error" or "mask"')
        if lists not in ("error", "pad"):
            raise ValueError('lists must be "error" or "pad"')
        if lists == "pad":
            if max_list_len is None or max_list_len <= 0:
                raise ValueError('lists="pad" requires a positive max_list_len')
            # eager, like every other argument: nested lists fail at the
            # call, not at the first next() deep in a train loop
            sel = resolve_column_prefixes(self.schema, columns) if columns else self._selected
            for leaf in self.schema.leaves:
                if (sel is None or leaf.path in sel) and leaf.max_rep > 1:
                    raise ParquetFileError(
                        f"parquet: column {leaf.path_str} has {leaf.max_rep} "
                        "repetition levels; ragged batching covers "
                        "single-level LIST columns only"
                    )
        normalized = None
        if filters is not None:
            # eager, like every other argument: a bad column or op fails
            # here, not at the first next()
            normalized = normalize_dnf(self.schema, filters)
        if filter_rows and normalized is None:
            raise ValueError("filter_rows=True requires filters")
        dev = self.device if device is None else resolve_device(device)
        batches = self._iter_device_batches(
            batch_size, columns, drop_remainder, nullable, lists, max_list_len, dev,
            normalized, filter_rows,
        )
        if sharding is None:
            return batches
        from ..parallel.scan import _resolve

        _group, rank, world = _resolve(sharding)
        if batch_size % world:
            raise ValueError(
                f"batch_size {batch_size} is not divisible over the {world} ranks of sharding"
            )
        return _shard_batches(batches, rank, world)

    def _iter_device_batches(
        self, batch_size: int, columns, drop_remainder: bool, nullable: str,
        lists: str, max_list_len, dev: torch.device, normalized, filter_rows: bool,
    ):
        def _ragged(path, dc, arr):
            leaf = self.schema.column(path)
            name = ".".join(path)
            if leaf.max_rep != 1:
                raise ParquetFileError(
                    f"parquet: column {name} has {leaf.max_rep} repetition levels; "
                    "ragged batching covers single-level LIST columns only"
                )
            rl = np.asarray(dc.rep_levels)
            starts = np.nonzero(rl == 0)[0]
            if dc.def_levels is not None:
                dl = np.asarray(dc.def_levels)
                present = dl == leaf.max_def
                # a null ELEMENT (optional leaf, def one below max) would
                # silently left-shift its row's survivors, so refuse
                if leaf.repetition == FieldRepetitionType.OPTIONAL and bool(
                    (dl == leaf.max_def - 1).any()
                ):
                    raise ParquetFileError(
                        f"parquet: column {name} has null elements inside lists; "
                        "ragged batching would shift positions (fill nulls upstream)"
                    )
            else:
                present = np.ones(len(rl), dtype=bool)
            # every row owns >= 1 level entry (null/empty lists carry one
            # below-max entry), so reduceat over row starts counts elements
            lengths = (
                np.add.reduceat(present.astype(np.int32), starts)
                if len(starts)
                else np.zeros(0, dtype=np.int32)
            )
            if arr.shape[0] != int(present.sum()):
                raise ParquetFileError(f"parquet: column {name} level/value mismatch")
            if len(lengths) and int(lengths.max()) > max_list_len:
                raise ParquetFileError(
                    f"parquet: column {name} has a row with {int(lengths.max())} "
                    f"elements > max_list_len={max_list_len} (raise it, or filter upstream)"
                )
            return _pad_ragged_device(arr, to_device(lengths, dev), int(max_list_len))

        def _array_of(path, dc):
            arr = dc.values if dc.values is not None else dc.indices
            name = ".".join(path)
            if arr is None:
                raise ParquetFileError(
                    f"parquet: column {name} has no device array form "
                    "(raw byte-array columns cannot batch; project them out)"
                )
            if dc.rep_levels is not None:
                if lists == "pad":
                    return _ragged(path, dc, arr)
                raise ParquetFileError(
                    f"parquet: column {name} is repeated; its leaf slots are not "
                    'rows, so it cannot batch (project it out, or pass lists="pad" '
                    "with max_list_len)"
                )
            has_nulls = arr.shape[0] != dc.num_values
            if nullable == "mask" and dc.def_levels is not None:
                max_def = self.schema.column(path).max_def
                if max_def > 0:
                    mask = to_device(np.asarray(dc.def_levels) == max_def, dev)
                    if has_nulls:
                        return _expand_nullable_device(arr, mask)
                    # no nulls in THIS group, but the column is declared
                    # optional: keep the structure stable across batches
                    return MaskedColumn(values=arr, mask=mask)
            if has_nulls:
                raise ParquetFileError(
                    f"parquet: column {name} contains nulls; device batches need "
                    "null-free columns (filter or fill upstream, project the "
                    'column out, or pass nullable="mask")'
                )
            return arr

        if normalized is not None:
            # group-level push-down: excluded groups never touch the device
            groups = self._prune_groups_normalized(normalized)
        else:
            groups = list(range(self.num_row_groups))
        # row-level push-down reads the filter leaves too (the mask needs
        # them resident), but only the caller's projection batches
        proj = None
        read_columns = columns
        if filter_rows:
            proj = resolve_column_prefixes(self.schema, columns) if columns else self._selected
            read_columns = self._columns_with_filters(
                columns if columns else (sorted(proj) if proj else None), normalized
            )

        def stage(i):
            # prepare + upload + launch as futures, nothing delivered yet
            return self._plan_row_groups_async([i], read_columns, dev)[0]

        staged_next = stage(groups[0]) if groups else None
        carry: dict = {}
        carry_n = 0
        try:
            for gi, i in enumerate(groups):
                staged = staged_next
                staged_next = stage(groups[gi + 1]) if gi + 1 < len(groups) else None
                try:
                    group = {path: fut.result().device_column() for path, fut in staged}
                except BaseException:
                    _settle([staged])
                    raise
                del staged
                arrs = {
                    path: _array_of(path, dc)
                    for path, dc in group.items()
                    if proj is None or path in proj
                }
                if not arrs:
                    continue
                lengths = {t.shape[0] for t in _tree_leaves(arrs)}
                if len(lengths) != 1:
                    raise ParquetFileError(
                        f"parquet: columns disagree on row count in group {i}: "
                        f"{sorted(lengths)}"
                    )
                n = lengths.pop()
                if filter_rows:
                    arrs, n = self._device_filter_rows(i, group, normalized, arrs, n, dev)
                    if not n:
                        continue
                del group
                cat = _tree_map(lambda c, a: torch.cat([c, a]), carry, arrs) if carry_n else arrs
                total = carry_n + n
                # cursor slicing: each batch is one row slice; the tail is sliced
                # once per row group, not once per batch
                off = 0
                while total - off >= batch_size:
                    lo = off
                    yield _tree_map(lambda a, lo=lo: a[lo : lo + batch_size], cat)
                    off += batch_size
                carry_n = total - off
                carry = _tree_map(lambda a: a[off:], cat) if carry_n else {}
        finally:
            # a stream that fails, is closed or is dropped mid-file: the group
            # staged ahead finishes before the generator does
            if staged_next is not None:
                _settle([staged_next])
        if carry_n and not drop_remainder:
            yield carry

    # -- row-group pruning -----------------------------------------------------

    def prune_row_groups(self, filters) -> list[int]:
        """Row-group indices whose chunk statistics and bloom filters admit
        the filters: groups provably excluded by written min/max/null-count
        (or by a bloom filter proving an equality value absent) never load."""
        return self.prune_row_groups_counted(filters)[0]

    def prune_row_groups_counted(self, filters) -> tuple:
        """`(admitted_indices, stats_pruned, bloom_pruned)`: the pruning walk
        of prune_row_groups, attributing each excluded group to the rung
        that excluded it (statistics first, then bloom)."""
        return self._prune_counted(normalize_dnf(self.schema, filters))

    def _prune_counted(self, dnf) -> tuple:
        admitted: list[int] = []
        stats_pruned = bloom_pruned = 0
        for i in range(self.num_row_groups):
            # one walk per (group, conjunction): dnf_group_may_match's OR
            # semantics, unrolled so each stats evaluation happens once and
            # the excluding rung is known without a second pass
            rg = self.row_group(i)
            stats_ok = survives = False
            for conj in dnf:
                if not row_group_may_match(rg, conj):
                    continue
                stats_ok = True
                if self._bloom_excludes(i, conj):
                    continue
                survives = True
                break
            if survives:
                admitted.append(i)
            elif stats_ok:
                bloom_pruned += 1
            else:
                stats_pruned += 1
        return admitted, stats_pruned, bloom_pruned

    def _prune_groups_normalized(self, dnf) -> list[int]:
        """The groups a normalized DNF admits; the excluded ones are counted
        as groups_pruned_stats / groups_pruned_bloom."""
        admitted, stats_pruned, bloom_pruned = self._prune_counted(dnf)
        _bump("groups_pruned_stats", stats_pruned)
        _bump("groups_pruned_bloom", bloom_pruned)
        return admitted

    def read_page_index(self, i: int, columns=None) -> dict:
        """The Parquet page index of row group i: {leaf path: (ColumnIndex,
        OffsetIndex)}; columns whose chunk carries no index map to
        (None, None)."""
        out = {}
        for path, cc, _col in self._selected_chunks(i, columns):
            ci = oi = None
            try:
                if cc.column_index_offset and cc.column_index_length:
                    ci = ColumnIndex.loads(
                        self._pread(cc.column_index_offset, cc.column_index_length)
                    )
                if cc.offset_index_offset and cc.offset_index_length:
                    oi = OffsetIndex.loads(
                        self._pread(cc.offset_index_offset, cc.offset_index_length)
                    )
            except ThriftError as e:
                raise ParquetFileError(
                    f"parquet: corrupt page index for {'.'.join(path)}: {e}"
                ) from e
            out[path] = (ci, oi)
        return out

    def prune_pages(self, i: int, filters) -> list[tuple[int, int]]:
        """Row ranges of row group i that may contain rows matching
        `filters`, proven by the page index: sorted disjoint [(start,
        stop)); [(0, num_rows)] when the file has no page index or nothing
        can be pruned, [] when the whole group is provably empty of
        matches."""
        dnf = normalize_dnf(self.schema, filters)
        num_rows = self.row_group(i).num_rows or 0
        paths = [p for conj in dnf for p, *_ in conj]
        indexes = self.read_page_index(i, columns=paths) if paths else {}
        return dnf_page_ranges(dnf, indexes, num_rows)

    def read_bloom_filter(self, i: int, column):
        """The split-block bloom filter of one column chunk, or None when
        the chunk carries none."""
        path = tuple(column.split(".")) if isinstance(column, str) else tuple(column)
        if (i, path) in self._bloom_cache:
            return self._bloom_cache[(i, path)]
        for cc in self.row_group(i).columns or []:
            md = cc.meta_data
            if md is None or tuple(md.path_in_schema or []) != path:
                continue
            off = md.bloom_filter_offset
            if not off or off <= 0:
                self._bloom_cache[(i, path)] = None
                return None
            length = md.bloom_filter_length
            if not length or length <= 0:
                # header precedes the bitset; peek enough for the header,
                # parse numBytes, then take exactly header + bitset
                try:
                    r = CompactReader(self._pread(off, 64))
                    h = BloomFilterHeader.read(r)
                except ThriftError as e:
                    raise ParquetFileError(
                        f"parquet: corrupt bloom header for {'.'.join(path)}: {e}"
                    ) from e
                length = r.pos + (h.numBytes or 0)
            try:
                bf = BloomFilter.from_buffer(self._pread(off, length))
            except (ValueError, ThriftError) as e:
                raise ParquetFileError(
                    f"parquet: corrupt bloom filter for {'.'.join(path)}: {e}"
                ) from e
            self._bloom_cache[(i, path)] = bf
            return bf
        raise ParquetFileError(f"parquet: column {'.'.join(path)} not in row group")

    def _bloom_excludes(self, i: int, normalized) -> bool:
        """True when some equality predicate's value is PROVABLY absent from
        row group i per its bloom filter (false-positive-only structure:
        never excludes a group that contains the value)."""
        by_path = chunks_by_path(self.row_group(i))
        for path, leaf, op, _rv, vlo, vhi in normalized:
            if op == "==":
                if vlo is None or vlo != vhi:
                    continue
                probes = [vlo]
            elif op == "in":
                # exclusion needs EVERY member provably absent, so every
                # bracket must be exact ([] is handled by stats pruning)
                if not vlo or any(a != b for a, b in vlo):
                    continue
                probes = [a for a, _ in vlo]
            else:
                continue
            cc = by_path.get(path)
            if cc is None or not cc.meta_data.bloom_filter_offset:
                continue
            try:
                bf = self.read_bloom_filter(i, path)
            except ParquetFileError:
                continue  # corrupt filter: never exclude on it
            if bf is not None and all(
                not bf.might_contain(leaf.type, p, column_is_unsigned(leaf))
                for p in probes
            ):
                return True
        return False

    # -- lifetime --------------------------------------------------------------

    def close(self) -> None:
        """Release the source when this reader owns it (paths, URLs, bytes).
        Idempotent; caller-provided sources and file objects stay open."""
        if self._owns_file:
            self._source.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
