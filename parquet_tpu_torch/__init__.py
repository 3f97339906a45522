"""parquet_tpu_torch — Parquet column decode into GPU memory, on PyTorch.

The PyTorch/CUDA port of parquet_tpu's decode path. The host walks pages
(Thrift headers, decompression, R/D levels, run/block prescans); the value
streams of each column chunk go to the device as packed upload buffers and
are decoded there by hand-written CUDA kernels (kernels/csrc/): hybrid
RLE/bit-packed expansion, dictionary gather and DELTA_BINARY_PACKED decode.
Filters prune row groups by statistics and bloom filters and evaluate as
device row masks, compacted on the card. FileWriter writes device tensors
back to Parquet: the dictionary probe, the hybrid and DELTA encodes and the
byte-array framing run on the card, byte-identical to the host write;
host chunks encode in one native call each (the fused encode walk), with
bloom filters, the page index and a parallel encode pipeline as options.
Schemas come from the text DSL (parse_schema) or the typed builders
(schema.builder), and merge_files / split_row_groups copy row groups
between files without re-encoding.
Rows are a host path: FileReader.iter_rows (filters=, raw=) assembles
Python dicts from the host decode, FileWriter.write_row / write_rows shreds
them into the same chunk encode, and floor.Writer / floor.Reader map
dataclasses onto both.
Bytes come through the io layer (parquet_tpu_torch.io): a path reads with
os.pread, an http(s):// URL with range GETs (signed, retried, hedged and
breaker-gated as configured), through block, footer and RAM -> disk tiered
caches; the reader's on_error, max_memory and compact_levels ride on it,
and io_counts() reads its counters. Bytes leave the same way: FileWriter
and merge_files take an http(s):// URL as their destination (HttpSink,
atomic multipart PUTs committed at close). The lake layer
(parquet_tpu_torch.lake) keeps a table of such files: IngestWriter appends,
Compactor folds, and a table directory or a _lake/gen-N.json path is a
dataset source pinned to one generation.
Aggregation queries (serve.run_local_query) filter and reduce each row
group on the card; the scan daemon (ScanServer(ServeConfig(...))) answers
them over HTTP (POST /v1/query), streams rows (POST /v1/scan), plans
(/v1/plan) and appends to a lake table (POST /v1/append) under admission
control, and serve_counts() reads its counters; a MeshRouter(MeshConfig(
replicas=...)) puts the same surface in front of a fleet of such daemons,
scattering each request's units over them (mesh_counts()). Scans (parallel.column_stats,
distributed_column_stats, sharded_decode_step) spread row groups and pages
over devices and torch.distributed ranks.
Observability (parquet_tpu_torch.obs, utils.trace, utils.metrics), as the
reference's: every *_counts() above is a view of one process metrics
registry (Prometheus and OpenMetrics expositions); utils.trace.decode_trace
collects a read's span tree across the pqt-* pools; the daemon keeps a
flight recorder, tenant cost, JSON-lines logs, a sampling profiler,
traceparent propagation and a fleet view under /v1/debug/*.

    from parquet_tpu_torch import FileReader
    with FileReader("trips.parquet") as r:          # device=None -> CUDA
        groups = r.read_row_groups_device()         # [{path: DeviceColumn}]

    for batch in FileReader("trips.parquet").iter_device_batches(
            100_000, nullable="mask", lists="pad", max_list_len=16):
        ...                                         # {path: Tensor | MaskedColumn | RaggedColumn}

    for batch in FileReader("trips.parquet").iter_device_batches(
            100_000, filters=[("fare", ">=", 1500)], filter_rows=True):
        ...                                         # matching rows only, compacted on the card

    schema = parse_schema("message m { required int32 fare; required binary zone; }")
    with FileWriter("out.parquet", schema, codec="snappy",
                    bloom_filters=["zone"], write_page_index=True) as w:
        w.write_device_column("fare", fare_tensor)  # a CUDA tensor
        w.write_device_column("zone", (data_u8, offsets_i64))
    write_counts()                                  # device_write_engaged / _declined, encode_fused_*

    for row in FileReader("trips.parquet").iter_rows(filters=[("fare", ">=", 1500)]):
        ...                                         # {"fare": 1612, "zone": "JFK", ...}
    row_counts()                                    # assemble_vec / _cursor, rows_filtered_*

`device="cpu"` runs the kernels' plain PyTorch versions on the CPU; without
it a machine with no CUDA raises.
"""

__version__ = "0.1.0"

from .core.alloc import AllocError
from .core.arrays import ByteArrayData
from .core.chunk import ChunkData, ChunkError, read_chunk
from .core.compress import CompressionError, register_codec
from .core.page import PageError
from .core.filter import FilterError
from .core.filter_device import DeviceFilterError
from .core.filter_vec import VecFilterError
from .core.merge import merge_files, split_row_groups
from .core.reader import (
    BACKENDS,
    FileReader,
    MaskedColumn,
    RaggedColumn,
    filter_counts,
    reset_filter_counts,
    reset_row_counts,
    row_counts,
)
from .core.schema import Column, Schema, SchemaError
from .core.writer import FileWriter, WriterError, reset_write_counts, write_counts
from .io import (
    BlockCache,
    ByteSource,
    FooterCache,
    HttpSink,
    HttpSource,
    LocalFileSource,
    MemorySource,
    ObjectStoreSink,
    ObjectStoreSource,
    RetryingSource,
    SourceError,
    TieredCache,
    TransientSourceError,
    io_counts,
    reset_io_counts,
)
from .kernels.pipeline import DecodeStats, DeviceColumn
from .meta import (
    CompressionCodec,
    ConvertedType,
    Encoding,
    FieldRepetitionType,
    LogicalType,
    PageType,
    ParquetFileError,
    Type,
    read_file_metadata,
)
from .ops.packed_levels import PackedLevels
from .schema import builder
from .schema.dsl import (
    SchemaParseError,
    parse_schema,
    schema_to_string,
    validate,
    validate_strict,
)
from .sink import (
    BufferedSink,
    ByteSink,
    FileObjectSink,
    LocalFileSink,
    MemorySink,
    SinkError,
)
from . import floor
from .data import ParquetDataset
from .serve import (
    AdmissionController,
    Deadline,
    MeshConfig,
    MeshRouter,
    PlannedScan,
    ScanServer,
    ScanService,
    ScanSession,
    ServeConfig,
    execute_query,
    execute_stream,
    mesh_counts,
    reset_mesh_counts,
    reset_serve_counts,
    serve_counts,
    serve_pool,
)

__all__ = [
    "AdmissionController",
    "AllocError",
    "BACKENDS",
    "BlockCache",
    "BufferedSink",
    "ByteArrayData",
    "ByteSink",
    "ByteSource",
    "ChunkData",
    "ChunkError",
    "Column",
    "CompressionCodec",
    "CompressionError",
    "ConvertedType",
    "Deadline",
    "DecodeStats",
    "DeviceColumn",
    "DeviceFilterError",
    "Encoding",
    "FieldRepetitionType",
    "FileObjectSink",
    "FileReader",
    "FileWriter",
    "FilterError",
    "FooterCache",
    "HttpSink",
    "HttpSource",
    "LocalFileSink",
    "LocalFileSource",
    "LogicalType",
    "MaskedColumn",
    "MemorySink",
    "MemorySource",
    "MeshConfig",
    "MeshRouter",
    "ObjectStoreSink",
    "ObjectStoreSource",
    "PackedLevels",
    "PageError",
    "PageType",
    "ParquetDataset",
    "ParquetFileError",
    "PlannedScan",
    "RaggedColumn",
    "RetryingSource",
    "ScanServer",
    "ScanService",
    "ScanSession",
    "Schema",
    "SchemaError",
    "SchemaParseError",
    "ServeConfig",
    "SinkError",
    "SourceError",
    "TieredCache",
    "TransientSourceError",
    "Type",
    "VecFilterError",
    "WriterError",
    "builder",
    "execute_query",
    "execute_stream",
    "filter_counts",
    "floor",
    "io_counts",
    "merge_files",
    "mesh_counts",
    "parse_schema",
    "read_chunk",
    "read_file_metadata",
    "register_codec",
    "reset_filter_counts",
    "reset_io_counts",
    "reset_mesh_counts",
    "reset_row_counts",
    "reset_serve_counts",
    "reset_write_counts",
    "row_counts",
    "schema_to_string",
    "serve_counts",
    "serve_pool",
    "split_row_groups",
    "validate",
    "validate_strict",
    "write_counts",
]
