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

The device is explicit: `device=None` means `torch.device("cuda")`, and a
reader built without a device on a machine with no CUDA raises rather than
decoding on the CPU. Pass `device="cpu"` to run the kernels' plain PyTorch
versions on the CPU.
"""

from __future__ import annotations

import io
import os
import threading
from collections import Counter
from concurrent.futures import ThreadPoolExecutor, wait
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

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
from ..meta.parquet_types import BloomFilterHeader, FieldRepetitionType, FileMetaData, RowGroup
from ..meta.thrift import CompactReader, ThriftError
from ..utils.native import get_native
from .bloom import BloomFilter
from .chunk import ChunkData, ChunkError, ChunkWindow, chunk_byte_range, read_chunk
from .filter import chunks_by_path, normalize_dnf, row_group_may_match
from .filter_device import DeviceFilterError, device_dnf_mask
from .filter_vec import dnf_mask
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
    "resolve_device",
]

BACKENDS = ("host", "device", "device_roundtrip")

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
    ):
        """`metadata=` reuses a footer already parsed (open_metadata) and
        `schema=` a Schema already built for it: the dataset layer opens one
        reader a row group, and neither parses again."""
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}: expected one of {BACKENDS}")
        self.device = resolve_device(device)
        self.backend = backend
        self.validate_crc = validate_crc
        # page routing counts of every device plan this reader made
        self.stats = DecodeStats()
        self._lock = threading.Lock()
        self._bloom_cache: dict = {}
        if isinstance(source, (str, Path)):
            self._f = open(source, "rb")
            self._owns_file = True
        elif isinstance(source, (bytes, bytearray, memoryview)):
            self._f = io.BytesIO(bytes(source))
            self._owns_file = True
        else:
            self._f = source
            self._owns_file = False
        try:
            self._size = self._f.seek(0, io.SEEK_END)
            self.metadata: FileMetaData = (
                metadata if metadata is not None else read_file_metadata(self._f)
            )
            self.schema = schema if schema is not None else Schema.from_thrift(self.metadata.schema)
            self._selected = resolve_column_prefixes(self.schema, columns)
        except BaseException:
            self.close()
            raise

    @classmethod
    def open_metadata(cls, path) -> FileMetaData:
        """Parse only the footer of `path`: no data page is read and no
        handle survives the call (the dataset's planning primitive)."""
        with open(path, "rb") as f:
            return read_file_metadata(f)

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
        for cc in self.row_group(i).columns or []:
            md = cc.meta_data
            if md is None:
                raise ParquetFileError("parquet: column chunk without metadata")
            path = tuple(md.path_in_schema or [])
            if selected is not None and path not in selected:
                continue
            yield path, cc, self.schema.column(path)

    def _window(self, cc) -> ChunkWindow:
        """One chunk's page bytes in one read. A range past the end of the
        file reads short, and the page walk raises its typed error."""
        offset, total = chunk_byte_range(cc)
        if offset >= self._size or total <= 0:
            return ChunkWindow(b"", offset)
        return ChunkWindow(self._pread(offset, min(total, self._size - offset)), offset)

    def _pread(self, offset: int, length: int) -> bytes:
        with self._lock:
            self._f.seek(offset)
            return self._f.read(length)

    # -- host delivery ---------------------------------------------------------

    def read_row_group(self, i: int, columns=None) -> dict[tuple, ChunkData]:
        """Decode one row group into {leaf path: ChunkData}. On the host, or
        with backend="device_roundtrip" through the device and back."""
        if self.backend == "device_roundtrip":
            plans = self._plan_row_group(i, columns, self.device)
            return {path: plan.finalize() for path, plan in plans.items()}
        return self._read_host(i, columns)

    def _read_host(self, i: int, columns) -> dict[tuple, ChunkData]:
        return {
            path: read_chunk(self._window(cc), cc, column, validate_crc=self.validate_crc)
            for path, cc, column in self._selected_chunks(i, columns)
        }

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
                self._window(cc), cc, column, validate_crc=self.validate_crc, stats=self.stats
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
            return {path: plan.device_column() for path, plan in plans.items()}
        normalized = normalize_dnf(self.schema, filters)
        plans = self._plan_row_group(i, self._columns_with_filters(columns, normalized), dev)
        cols = {path: plan.device_column() for path, plan in plans.items()}
        n = int(self.row_group(i).num_rows or 0)
        return cols, self._device_group_mask(i, cols, normalized, n, dev)

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
        chunks = self._read_host(i, cols) if cols else {}
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
        staged = self._plan_row_groups_async(list(indices), columns, dev)
        try:
            return [{path: fut.result().device_column() for path, fut in group} for group in staged]
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
        if self._owns_file and self._f is not None:
            self._f.close()
        self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
