"""parquet_tpu_torch — Parquet column decode into GPU memory, on PyTorch.

The PyTorch/CUDA port of parquet_tpu's decode path. The host walks pages
(Thrift headers, decompression, R/D levels, run/block prescans); the value
streams of each column chunk go to the device as packed upload buffers and
are decoded there by hand-written CUDA kernels (kernels/csrc/): hybrid
RLE/bit-packed expansion, dictionary gather and DELTA_BINARY_PACKED decode.
Filters prune row groups by statistics and bloom filters and evaluate as
device row masks, compacted on the card. FileWriter writes device tensors
back to Parquet: the dictionary probe, the hybrid and DELTA encodes and the
byte-array framing run on the card, byte-identical to the host write.
Aggregation queries (serve.run_local_query) filter and reduce each row
group on the card, and scans (parallel.column_stats,
distributed_column_stats, sharded_decode_step) spread row groups and pages
over devices and torch.distributed ranks.

    from parquet_tpu_torch import FileReader
    with FileReader("trips.parquet") as r:          # device=None -> CUDA
        groups = r.read_row_groups_device()         # [{path: DeviceColumn}]

    for batch in FileReader("trips.parquet").iter_device_batches(
            100_000, nullable="mask", lists="pad", max_list_len=16):
        ...                                         # {path: Tensor | MaskedColumn | RaggedColumn}

    for batch in FileReader("trips.parquet").iter_device_batches(
            100_000, filters=[("fare", ">=", 1500)], filter_rows=True):
        ...                                         # matching rows only, compacted on the card

    with FileWriter("out.parquet", schema, codec="snappy") as w:
        w.write_device_column("fare", fare_tensor)  # a CUDA tensor
        w.write_device_column("zone", (data_u8, offsets_i64))
    write_counts()                                  # device_write_engaged / _declined

`device="cpu"` runs the kernels' plain PyTorch versions on the CPU; without
it a machine with no CUDA raises.
"""

from .core.arrays import ByteArrayData
from .core.chunk import ChunkData, ChunkError, read_chunk
from .core.compress import CompressionError
from .core.page import PageError
from .core.filter import FilterError
from .core.filter_device import DeviceFilterError
from .core.filter_vec import VecFilterError
from .core.reader import (
    BACKENDS,
    FileReader,
    MaskedColumn,
    RaggedColumn,
    filter_counts,
    reset_filter_counts,
)
from .core.schema import Column, Schema
from .core.writer import FileWriter, WriterError, reset_write_counts, write_counts
from .kernels.pipeline import DecodeStats, DeviceColumn
from .meta.file_meta import ParquetFileError, read_file_metadata

__all__ = [
    "BACKENDS",
    "ByteArrayData",
    "ChunkData",
    "ChunkError",
    "Column",
    "CompressionError",
    "DecodeStats",
    "DeviceColumn",
    "DeviceFilterError",
    "FileReader",
    "FileWriter",
    "FilterError",
    "MaskedColumn",
    "PageError",
    "ParquetFileError",
    "RaggedColumn",
    "Schema",
    "VecFilterError",
    "WriterError",
    "filter_counts",
    "read_chunk",
    "read_file_metadata",
    "reset_filter_counts",
    "reset_write_counts",
    "write_counts",
]
