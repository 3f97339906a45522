"""Parquet file footer handling: magic validation, footer length, FileMetaData.

Semantics follow the reference's file_meta.go: `PAR1` magic at both ends
(file_meta.go:14), 8-byte tail = footer length + magic, strict size checks before
reading (file_meta.go:25-62).
"""

from __future__ import annotations

import io
import struct

from .parquet_types import FileMetaData
from .thrift import CompactReader, ThriftError

MAGIC = b"PAR1"
FOOTER_TAIL = 8  # 4-byte little-endian footer length + MAGIC


class ParquetFileError(ValueError):
    pass


def read_file_metadata(f) -> FileMetaData:
    """Read and validate the footer of a seekable binary stream.

    Mirrors ReadFileMetaData (reference: file_meta.go:18-74): validates leading and
    trailing magic, bounds-checks the footer length against the file size, then
    decodes the Thrift FileMetaData.
    """
    size = f.seek(0, io.SEEK_END)
    if size < len(MAGIC) + FOOTER_TAIL:
        raise ParquetFileError(f"parquet: file too small ({size} bytes)")
    f.seek(0)
    if f.read(4) != MAGIC:
        raise ParquetFileError("parquet: invalid leading magic, not a parquet file")
    f.seek(size - FOOTER_TAIL)
    tail = f.read(FOOTER_TAIL)
    if tail[4:] != MAGIC:
        raise ParquetFileError("parquet: invalid trailing magic, not a parquet file")
    (footer_len,) = struct.unpack("<I", tail[:4])
    if footer_len == 0 or footer_len > size - len(MAGIC) - FOOTER_TAIL:
        raise ParquetFileError(f"parquet: invalid footer length {footer_len}")
    f.seek(size - FOOTER_TAIL - footer_len)
    footer = f.read(footer_len)
    if len(footer) != footer_len:
        raise ParquetFileError("parquet: truncated footer")
    try:
        meta = FileMetaData.read(CompactReader(footer))
    except (ThriftError, RecursionError) as e:
        # Internal decode errors are converted at the API boundary, the way the
        # reference recovers panics into errors (reference: file_reader.go:177-184).
        raise ParquetFileError(f"parquet: corrupt footer: {e}") from e
    if not meta.schema:
        raise ParquetFileError("parquet: footer has no schema")
    return meta


def serialize_footer(meta: FileMetaData) -> bytes:
    """Footer bytes (thrift + length + magic) to append after the last row group,
    as FileWriter.Close does (reference: file_writer.go:325-347)."""
    payload = meta.dumps()
    return payload + struct.pack("<I", len(payload)) + MAGIC
