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
RaggedColumn for padded LIST columns). Chunks are planned and dispatched
serially on the calling thread, so every launch goes to that thread's
current CUDA stream.

The device is explicit: `device=None` means `torch.device("cuda")`, and a
reader built without a device on a machine with no CUDA raises rather than
decoding on the CPU. Pass `device="cpu"` to run the kernels' plain PyTorch
versions on the CPU.
"""

from __future__ import annotations

import io
import threading
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from ..kernels.device_ops import expand_nullable, pad_ragged
from ..kernels.pipeline import DecodeStats, DeviceColumn, plan_chunk_device, to_device
from ..meta.file_meta import ParquetFileError, read_file_metadata
from ..meta.parquet_types import FieldRepetitionType, FileMetaData, RowGroup
from .chunk import ChunkData, ChunkWindow, chunk_byte_range, read_chunk
from .schema import Schema

__all__ = [
    "FileReader",
    "BACKENDS",
    "MaskedColumn",
    "RaggedColumn",
    "resolve_device",
]

BACKENDS = ("host", "device", "device_roundtrip")


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
    ):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}: expected one of {BACKENDS}")
        self.device = resolve_device(device)
        self.backend = backend
        self.validate_crc = validate_crc
        # page routing counts of every device plan this reader made
        self.stats = DecodeStats()
        self._lock = threading.Lock()
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
            self.metadata: FileMetaData = read_file_metadata(self._f)
            self.schema = Schema.from_thrift(self.metadata.schema)
            self._selected = resolve_column_prefixes(self.schema, columns)
        except BaseException:
            self.close()
            raise

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
        with self._lock:
            self._f.seek(offset)
            buf = self._f.read(min(total, self._size - offset))
        return ChunkWindow(buf, offset)

    # -- host delivery ---------------------------------------------------------

    def read_row_group(self, i: int, columns=None) -> dict[tuple, ChunkData]:
        """Decode one row group into {leaf path: ChunkData}. On the host, or
        with backend="device_roundtrip" through the device and back."""
        if self.backend == "device_roundtrip":
            plans = self._plan_row_group(i, columns, self.device)
            return {path: plan.finalize() for path, plan in plans.items()}
        return {
            path: read_chunk(self._window(cc), cc, column, validate_crc=self.validate_crc)
            for path, cc, column in self._selected_chunks(i, columns)
        }

    # -- device delivery -------------------------------------------------------

    def _plan_row_group(self, i: int, columns, device):
        return {
            path: plan_chunk_device(
                self._window(cc), cc, column, device,
                validate_crc=self.validate_crc, stats=self.stats,
            )
            for path, cc, column in self._selected_chunks(i, columns)
        }

    def read_row_group_device(
        self, i: int, columns=None, device=None
    ) -> dict[tuple, DeviceColumn]:
        """Decode one row group straight into device memory: {leaf path:
        DeviceColumn}. `device` overrides the reader's device for this call."""
        dev = self.device if device is None else resolve_device(device)
        plans = self._plan_row_group(i, columns, dev)
        return {path: plan.device_column() for path, plan in plans.items()}

    def read_row_groups_device(
        self, row_groups=None, columns=None, device=None
    ) -> list[dict[tuple, DeviceColumn]]:
        """Decode row groups into device memory, in row-group order. Every
        chunk of every group is dispatched before the first is delivered, so
        the uploads and launches queue back to back on the stream."""
        dev = self.device if device is None else resolve_device(device)
        indices = range(self.num_row_groups) if row_groups is None else row_groups
        staged = [self._plan_row_group(i, columns, dev) for i in indices]
        return [
            {path: plan.device_column() for path, plan in plans.items()}
            for plans in staged
        ]

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
        batches, group i+1 is already prepared and dispatched (one-group
        lookahead): memory stays bounded by two row groups plus the carry.
        With drop_remainder=False the final short batch is yielded as is.

        `device` overrides the reader's device for every batch. All work runs
        on the calling thread's current CUDA stream.
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
        dev = self.device if device is None else resolve_device(device)
        return self._iter_device_batches(
            batch_size, columns, drop_remainder, nullable, lists, max_list_len, dev
        )

    def _iter_device_batches(
        self, batch_size: int, columns, drop_remainder: bool, nullable: str,
        lists: str, max_list_len, dev: torch.device,
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

        groups = list(range(self.num_row_groups))

        def stage(i):
            # prepare + upload + launch, nothing delivered yet
            return self._plan_row_group(i, columns, dev)

        staged_next = stage(groups[0]) if groups else None
        carry: dict = {}
        carry_n = 0
        for gi, i in enumerate(groups):
            staged = staged_next
            staged_next = stage(groups[gi + 1]) if gi + 1 < len(groups) else None
            arrs = {
                path: _array_of(path, plan.device_column()) for path, plan in staged.items()
            }
            del staged
            if not arrs:
                continue
            lengths = {t.shape[0] for t in _tree_leaves(arrs)}
            if len(lengths) != 1:
                raise ParquetFileError(
                    f"parquet: columns disagree on row count in group {i}: "
                    f"{sorted(lengths)}"
                )
            n = lengths.pop()
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
        if carry_n and not drop_remainder:
            yield carry

    # -- lifetime --------------------------------------------------------------

    def close(self) -> None:
        if self._owns_file and self._f is not None:
            self._f.close()
        self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
