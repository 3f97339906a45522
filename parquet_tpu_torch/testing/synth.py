"""Build a Parquet file from NumPy columns with the port's own encoders.

A small writer for tests and for `chip_smoke.py`: a flat schema of REQUIRED
or OPTIONAL leaves, one codec, data page version and encoding per column,
row groups of a fixed row count, and pages cut at about `page_bytes` of
encoded values. It uses only the port's page encoders (core/page.py), its
Thrift writer and `serialize_footer`, so it runs where neither pyarrow nor
the JAX package is installed.

    spec = ColumnSpec("fare", Type.INT32, values=fares,
                      encoding=Encoding.DELTA_BINARY_PACKED)
    write_file("out.parquet", [spec], row_group_rows=1 << 20)

Dictionary-encoded columns take their dictionary and the per-row indices
(`dictionary=`, `indices=`) instead of `values`; every row group's
dictionary page holds the whole dictionary. An OPTIONAL column takes a
`valid` mask over all rows, and `values`/`indices` hold the non-null cells
only.
"""

from __future__ import annotations

import io
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from ..core.arrays import ByteArrayData
from ..core.page import encode_data_page_v1, encode_data_page_v2, encode_dict_page
from ..core.schema import Schema
from ..meta.file_meta import MAGIC, serialize_footer
from ..meta.parquet_types import (
    ColumnChunk,
    ColumnMetaData,
    CompressionCodec,
    ConvertedType,
    Encoding,
    FieldRepetitionType,
    FileMetaData,
    RowGroup,
    SchemaElement,
    Type,
)

__all__ = ["ColumnSpec", "write_file", "column_values"]

_DICT = (Encoding.RLE_DICTIONARY, Encoding.PLAIN_DICTIONARY)


@dataclass
class ColumnSpec:
    name: str
    type: Type
    values: object = None  # ndarray | ByteArrayData (non-null cells)
    encoding: Encoding = Encoding.PLAIN
    codec: CompressionCodec = CompressionCodec.UNCOMPRESSED
    page_version: int = 1
    valid: np.ndarray | None = None  # bool[num_rows]: OPTIONAL column
    dictionary: object = None  # ndarray | ByteArrayData (dictionary encodings)
    indices: np.ndarray | None = None  # int32 (non-null cells)
    utf8: bool = False  # BYTE_ARRAY annotated as a UTF-8 string

    @property
    def dict_encoded(self) -> bool:
        return Encoding(self.encoding) in _DICT

    def cells(self):
        """The non-null cells as written: indices or values."""
        return self.indices if self.dict_encoded else self.values

    def num_rows(self) -> int:
        if self.valid is not None:
            return len(self.valid)
        return len(self.cells())


def column_values(spec: ColumnSpec):
    """The non-null values the column decodes to (dictionary gathered)."""
    if not spec.dict_encoded:
        return spec.values
    if isinstance(spec.dictionary, ByteArrayData):
        return spec.dictionary.take(spec.indices)
    return np.asarray(spec.dictionary)[spec.indices]


def _slice(cells, lo: int, hi: int):
    if isinstance(cells, ByteArrayData):
        o = cells.offsets
        return ByteArrayData(
            offsets=o[lo : hi + 1] - o[lo], data=cells.data[int(o[lo]) : int(o[hi])]
        )
    return cells[lo:hi]


def _schema(specs: list[ColumnSpec]) -> Schema:
    elems = [SchemaElement(name="schema", num_children=len(specs))]
    for s in specs:
        elems.append(
            SchemaElement(
                type=int(s.type),
                repetition_type=int(
                    FieldRepetitionType.OPTIONAL
                    if s.valid is not None
                    else FieldRepetitionType.REQUIRED
                ),
                name=s.name,
                converted_type=int(ConvertedType.UTF8) if s.utf8 else None,
            )
        )
    return Schema.from_thrift(elems)


def _rows_per_page(spec, column, cell_prefix, page_bytes: int, rg_rows: int) -> int:
    """Rows per page so a page's encoded values come to about page_bytes,
    measured by encoding a sample of the column's first rows."""
    sample = min(rg_rows, len(cell_prefix) - 1, 1 << 16)
    if sample == 0:
        return rg_rows
    lo, hi = int(cell_prefix[0]), int(cell_prefix[sample])
    nbytes = len(
        _encode_values_only(spec, column, _slice(spec.cells(), lo, hi))
    )
    return max(8, min(rg_rows, int(page_bytes * sample / max(nbytes, 1))))


def _encode_values_only(spec, column, cells) -> bytes:
    dict_size = len(spec.dictionary) if spec.dict_encoded else None
    _h, block = encode_data_page_v1(
        _required(column), cells, None, None, spec.encoding,
        CompressionCodec.UNCOMPRESSED, dict_size,
    )
    return block


def _required(column):
    """The leaf seen as REQUIRED (no level streams): for size sampling."""
    import copy

    c = copy.copy(column)
    c.max_def = 0
    return c


def write_file(
    dest,
    specs: list[ColumnSpec],
    row_group_rows: int,
    page_bytes: int = 1 << 20,
):
    """Write the columns as a Parquet file to `dest` (a path or a binary
    file object); returns the FileMetaData written."""
    num_rows = specs[0].num_rows()
    if any(s.num_rows() != num_rows for s in specs):
        raise ValueError("synth: columns have different row counts")
    schema = _schema(specs)
    out = open(dest, "wb") if isinstance(dest, (str, Path)) else dest
    try:
        out.write(MAGIC)
        pos = len(MAGIC)
        # cell index at each row: prefix count of the valid mask
        prefixes = []
        for s in specs:
            if s.valid is None:
                prefixes.append(np.arange(num_rows + 1, dtype=np.int64))
            else:
                p = np.zeros(num_rows + 1, dtype=np.int64)
                np.cumsum(s.valid, out=p[1:])
                prefixes.append(p)
        page_rows = [
            _rows_per_page(s, schema.column((s.name,)), pre, page_bytes, row_group_rows)
            for s, pre in zip(specs, prefixes)
        ]
        row_groups = []
        for r0 in range(0, num_rows, row_group_rows):
            r1 = min(num_rows, r0 + row_group_rows)
            chunks = []
            total = 0
            for s, pre, step in zip(specs, prefixes, page_rows):
                column = schema.column((s.name,))
                cc, nbytes = _write_chunk(out, pos, s, column, pre, r0, r1, step)
                pos += nbytes
                total += cc.meta_data.total_uncompressed_size
                chunks.append(cc)
            row_groups.append(
                RowGroup(columns=chunks, total_byte_size=total, num_rows=r1 - r0)
            )
        meta = FileMetaData(
            version=1 if all(s.page_version == 1 for s in specs) else 2,
            schema=schema.to_thrift(),
            num_rows=num_rows,
            row_groups=row_groups,
            created_by="parquet_tpu_torch.testing.synth",
        )
        out.write(serialize_footer(meta))
    finally:
        if out is not dest:
            out.close()
    return meta


def _write_chunk(out, pos, spec, column, prefix, r0, r1, step):
    """Write one column chunk at file position `pos`: (ColumnChunk, bytes)."""
    buf = io.BytesIO()
    uncompressed = 0
    dict_offset = None
    encodings = {int(Encoding.RLE)} if spec.valid is not None else set()
    dict_size = None
    if spec.dict_encoded:
        header, block = encode_dict_page(column, spec.dictionary, int(spec.codec))
        hbytes = header.dumps()
        dict_offset = pos
        buf.write(hbytes)
        buf.write(block)
        uncompressed += len(hbytes) + header.uncompressed_page_size
        encodings.add(int(Encoding.PLAIN))
        dict_size = len(spec.dictionary)
    encodings.add(int(spec.encoding))
    data_offset = pos + buf.tell()
    encode = encode_data_page_v1 if spec.page_version == 1 else encode_data_page_v2
    for p0 in range(r0, r1, step):
        p1 = min(r1, p0 + step)
        cells = _slice(spec.cells(), int(prefix[p0]), int(prefix[p1]))
        dfl = (
            spec.valid[p0:p1].astype(np.uint16) if spec.valid is not None else None
        )
        header, block = encode(
            column, cells, dfl, None, spec.encoding, int(spec.codec), dict_size
        )
        hbytes = header.dumps()
        buf.write(hbytes)
        buf.write(block)
        uncompressed += len(hbytes) + header.uncompressed_page_size
    data = buf.getvalue()
    out.write(data)
    md = ColumnMetaData(
        type=int(spec.type),
        encodings=sorted(encodings),
        path_in_schema=[spec.name],
        codec=int(spec.codec),
        num_values=r1 - r0,
        total_uncompressed_size=uncompressed,
        total_compressed_size=len(data),
        data_page_offset=data_offset,
        dictionary_page_offset=dict_offset,
    )
    cc = ColumnChunk(
        file_offset=dict_offset if dict_offset is not None else data_offset,
        meta_data=md,
    )
    return cc, len(data)
