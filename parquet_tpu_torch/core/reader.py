"""FileReader: footer, column selection, and row-group decode on the host or
into device memory.

A subset of parquet_tpu.core.reader.FileReader. The backends:

  "host"              read_row_group decodes on the host (core.chunk).
  "device"            the same; device delivery is read_row_group_device.
  "device_roundtrip"  read_row_group forces device decode and a fetch: the
                      parity oracle against the host decode.

read_row_group_device / read_row_groups_device decode straight into device
memory on every backend. Chunks are planned and dispatched serially on the
calling thread, so every launch goes to that thread's current CUDA stream.

The device is explicit: `device=None` means `torch.device("cuda")`, and a
reader built without a device on a machine with no CUDA raises rather than
decoding on the CPU. Pass `device="cpu"` to run the kernels' plain PyTorch
versions on the CPU.
"""

from __future__ import annotations

import io
import threading
from pathlib import Path

import torch

from ..kernels.pipeline import DecodeStats, DeviceColumn, plan_chunk_device
from ..meta.file_meta import ParquetFileError, read_file_metadata
from ..meta.parquet_types import FileMetaData, RowGroup
from .chunk import ChunkData, ChunkWindow, chunk_byte_range, read_chunk
from .schema import Schema

__all__ = ["FileReader", "BACKENDS", "resolve_device"]

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

    # -- lifetime --------------------------------------------------------------

    def close(self) -> None:
        if self._owns_file and self._f is not None:
            self._f.close()
        self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
