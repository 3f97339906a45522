"""Build a Parquet file from NumPy columns with the port's own encoders.

A small writer for tests and for `chip_smoke.py`: a schema of REQUIRED or
OPTIONAL leaves and single-level LIST columns, one codec, data page version
and encoding per column, row groups of a fixed row count, and pages cut at
about `page_bytes` of encoded values (always at record boundaries). It uses only the port's page encoders (core/page.py), its
Thrift writer and `serialize_footer`, so it runs where neither pyarrow nor
the JAX package is installed.

    spec = ColumnSpec("fare", Type.INT32, values=fares,
                      encoding=Encoding.DELTA_BINARY_PACKED)
    write_file("out.parquet", [spec], row_group_rows=1 << 20)

Dictionary-encoded columns take their dictionary and the per-row indices
(`dictionary=`, `indices=`) instead of `values`; every row group's
dictionary page holds the whole dictionary. With `dict_fallback_bytes=`, a
column is written as pyarrow writes one under its dictionary_pagesize_limit:
each chunk's dictionary holds the entries in the order the chunk first uses
them, and once adding the next new entry would take the dictionary page's
PLAIN size past the limit, the chunk's remaining rows go out as PLAIN pages
(a mixed dict/PLAIN chunk). An OPTIONAL column takes a `valid` mask over all
rows, and `values`/`indices` hold the non-null cells only. Any codec the
port registers can be named (SNAPPY and LZ4 through the port's host
library), and BYTE_STREAM_SPLIT serves FLOAT, DOUBLE, INT32 and INT64.

Every chunk carries its Statistics (min_value / max_value, null_count and
the legacy min / max), computed with the port's copy of the JAX writer's
compute_statistics, so row groups prune on them as on the JAX writer's
files.

A spec with `list_lengths=` (elements per row) is a LIST column, written as

    optional group <name> (LIST) {
      repeated group list { required|optional <type> element }
    }

with repetition and definition levels: `valid` marks null lists (False;
such a row has length 0), a row of length 0 that is valid is an empty
list, and `element_valid` (one flag per element) makes the element
optional, False marking a null element. `values`/`indices` hold the
non-null elements only, and the leaf's path is (name, "list", "element").
"""

from __future__ import annotations

import io
from dataclasses import dataclass
from pathlib import Path
from typing import NamedTuple

import numpy as np

from ..core.arrays import ByteArrayData
from ..core.page import encode_data_page_v1, encode_data_page_v2, encode_dict_page
from ..core.schema import Schema
from ..core.stats import column_is_unsigned, compute_statistics
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

__all__ = [
    "ColumnSpec",
    "DeltaCase",
    "FrameCase",
    "HYBRID_EDGE_WIDTHS",
    "HybridCase",
    "MaskTakeCase",
    "MixedBytesCase",
    "PadCase",
    "bytearray_frame_edge_cases",
    "column_levels",
    "column_values",
    "delta_edge_batches",
    "delta_edge_cases",
    "dict_indices_edge_cases",
    "frame_args",
    "freeze_delta_case",
    "freeze_hybrid_case",
    "hybrid_edge_batches",
    "hybrid_edge_cases",
    "mask_take_args",
    "mask_take_edge_cases",
    "mixed_bytes_args",
    "mixed_bytes_edge_cases",
    "most_runs_a_tile",
    "out_of_range_indices",
    "pad_ragged_edge_cases",
    "pad_ragged_tile_rows",
    "write_file",
]

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
    # PLAIN size at which a chunk's dictionary stops growing and the rest of
    # the chunk falls back to PLAIN pages (pyarrow's dictionary_pagesize_limit)
    dict_fallback_bytes: int | None = None
    # LIST column: elements per row (0 for a null or an empty list)
    list_lengths: np.ndarray | None = None
    # LIST column with an optional element: bool per element, False = null
    element_valid: np.ndarray | None = None

    @property
    def dict_encoded(self) -> bool:
        return Encoding(self.encoding) in _DICT

    @property
    def is_list(self) -> bool:
        return self.list_lengths is not None

    @property
    def path(self) -> tuple:
        return (self.name, "list", "element") if self.is_list else (self.name,)

    def cells(self):
        """The non-null cells as written: indices or values."""
        return self.indices if self.dict_encoded else self.values

    def num_rows(self) -> int:
        if self.is_list:
            return len(self.list_lengths)
        if self.valid is not None:
            return len(self.valid)
        return len(self.cells())


class _Levels(NamedTuple):
    """A column's level streams over the whole file, and per-row prefixes
    into them: row r owns level entries entries[r]:entries[r + 1] and
    non-null cells cells[r]:cells[r + 1]."""

    def_levels: np.ndarray | None  # uint16[entries]
    rep_levels: np.ndarray | None  # uint16[entries]
    entries: np.ndarray  # int64[num_rows + 1]
    cells: np.ndarray  # int64[num_rows + 1]


def _levels(spec: ColumnSpec, column) -> _Levels:
    num_rows = spec.num_rows()
    if not spec.is_list:
        entries = np.arange(num_rows + 1, dtype=np.int64)
        if spec.valid is None:
            return _Levels(None, None, entries, entries)
        cells = np.zeros(num_rows + 1, dtype=np.int64)
        np.cumsum(spec.valid, out=cells[1:])
        return _Levels(spec.valid.astype(np.uint16), None, entries, cells)
    lengths = np.asarray(spec.list_lengths, dtype=np.int64)
    if spec.valid is not None and lengths[~spec.valid].any():
        raise ValueError(f"synth: {spec.name}: a null list must have length 0")
    per_row = np.maximum(lengths, 1)
    entries = np.zeros(num_rows + 1, dtype=np.int64)
    np.cumsum(per_row, out=entries[1:])
    n_entries = int(entries[-1])
    starts = entries[:-1]
    rep = np.ones(n_entries, dtype=np.uint16)
    rep[starts] = 0
    max_def = column.max_def
    dfl = np.full(n_entries, max_def, dtype=np.uint16)
    empty = lengths == 0
    # an empty list is defined through the repeated group's parent (def 1),
    # a null list is not (def 0)
    dfl[starts[empty]] = 1
    if spec.valid is not None:
        dfl[starts[~spec.valid]] = 0
    n_elems = int(lengths.sum())
    elem_prefix = np.zeros(num_rows + 1, dtype=np.int64)
    np.cumsum(lengths, out=elem_prefix[1:])
    if spec.element_valid is None:
        cells = elem_prefix
    else:
        ev = np.asarray(spec.element_valid, dtype=bool)
        if len(ev) != n_elems:
            raise ValueError(f"synth: {spec.name}: {len(ev)} element flags for {n_elems} elements")
        is_elem = np.repeat(~empty, per_row)
        dfl[is_elem] = np.where(ev, max_def, max_def - 1).astype(np.uint16)
        valid_prefix = np.zeros(n_elems + 1, dtype=np.int64)
        np.cumsum(ev, out=valid_prefix[1:])
        cells = valid_prefix[elem_prefix]
    return _Levels(dfl, rep, entries, cells)


def column_values(spec: ColumnSpec):
    """The non-null values the column decodes to (dictionary gathered)."""
    if not spec.dict_encoded:
        return spec.values
    if isinstance(spec.dictionary, ByteArrayData):
        return spec.dictionary.take(spec.indices)
    return np.asarray(spec.dictionary)[spec.indices]


def column_levels(spec: ColumnSpec) -> tuple:
    """The (def, rep) level streams the column is written with, over all
    rows (uint16; None where the column has no such stream)."""
    lv = _levels(spec, _schema([spec]).column(spec.path))
    return lv.def_levels, lv.rep_levels


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
        if s.is_list:
            elems += [
                SchemaElement(
                    name=s.name,
                    repetition_type=int(FieldRepetitionType.OPTIONAL),
                    num_children=1,
                    converted_type=int(ConvertedType.LIST),
                ),
                SchemaElement(
                    name="list",
                    repetition_type=int(FieldRepetitionType.REPEATED),
                    num_children=1,
                ),
                SchemaElement(
                    type=int(s.type),
                    repetition_type=int(
                        FieldRepetitionType.OPTIONAL
                        if s.element_valid is not None
                        else FieldRepetitionType.REQUIRED
                    ),
                    name="element",
                    converted_type=int(ConvertedType.UTF8) if s.utf8 else None,
                ),
            ]
            continue
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


def _encode_values_only(spec, column, cells, encoding=None) -> bytes:
    encoding = spec.encoding if encoding is None else encoding
    dict_size = len(spec.dictionary) if Encoding(encoding) in _DICT else None
    _h, block = encode_data_page_v1(
        _required(column), cells, None, None, encoding,
        CompressionCodec.UNCOMPRESSED, dict_size,
    )
    return block


def _plain_rows_per_page(spec, column, page_bytes: int, rg_rows: int) -> int:
    """Rows per PLAIN fallback page, as _rows_per_page measures it."""
    sample = min(rg_rows, len(spec.indices), 1 << 16)
    if sample == 0:
        return rg_rows
    cells = _take(spec.dictionary, spec.indices[:sample])
    nbytes = len(_encode_values_only(spec, column, cells, Encoding.PLAIN))
    return max(8, min(rg_rows, int(page_bytes * sample / max(nbytes, 1))))


def _take(dictionary, idx):
    if isinstance(dictionary, ByteArrayData):
        return dictionary.take(np.asarray(idx, dtype=np.int64))
    return np.asarray(dictionary)[idx]


def _entry_bytes(dictionary, keys: np.ndarray) -> np.ndarray:
    """PLAIN-encoded size of each dictionary entry in `keys`."""
    if isinstance(dictionary, ByteArrayData):
        lens = np.diff(dictionary.offsets)
        return lens[keys] + 4
    return np.full(len(keys), np.asarray(dictionary).dtype.itemsize, dtype=np.int64)


def _fallback_split(spec, cells: np.ndarray):
    """(chunk dictionary, remapped dict-page indices, count of dict-encoded
    cells) for a chunk whose dictionary passes spec.dict_fallback_bytes."""
    uniq, first = np.unique(cells, return_index=True)
    order = np.argsort(first, kind="stable")
    uniq, first = uniq[order], first[order]
    size = np.cumsum(_entry_bytes(spec.dictionary, uniq))
    k = int(np.searchsorted(size, spec.dict_fallback_bytes, side="right"))
    n_dict_cells = int(first[k]) if k < len(uniq) else len(cells)
    remap = np.zeros(int(uniq.max()) + 1 if len(uniq) else 1, dtype=np.int32)
    remap[uniq[:k]] = np.arange(k, dtype=np.int32)
    return _take(spec.dictionary, uniq[:k]), remap[cells[:n_dict_cells]], n_dict_cells


def _required(column):
    """The leaf seen as REQUIRED (no level streams): for size sampling."""
    import copy

    c = copy.copy(column)
    c.max_def = 0
    c.max_rep = 0
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
    for s in specs:
        if s.dict_fallback_bytes is not None and not s.dict_encoded:
            raise ValueError(f"synth: {s.name}: dict_fallback_bytes needs a dictionary encoding")
        if s.dict_fallback_bytes is not None and s.is_list:
            raise ValueError(f"synth: {s.name}: dict_fallback_bytes is for flat columns")
    schema = _schema(specs)
    out = open(dest, "wb") if isinstance(dest, (str, Path)) else dest
    try:
        out.write(MAGIC)
        pos = len(MAGIC)
        levels = [_levels(s, schema.column(s.path)) for s in specs]
        page_rows = [
            (
                _rows_per_page(s, schema.column(s.path), lv.cells, page_bytes, row_group_rows),
                _plain_rows_per_page(s, schema.column(s.path), page_bytes, row_group_rows)
                if s.dict_fallback_bytes is not None
                else None,
            )
            for s, lv in zip(specs, levels)
        ]
        row_groups = []
        for r0 in range(0, num_rows, row_group_rows):
            r1 = min(num_rows, r0 + row_group_rows)
            chunks = []
            total = 0
            for s, lv, steps in zip(specs, levels, page_rows):
                column = schema.column(s.path)
                cc, nbytes = _write_chunk(out, pos, s, column, lv, r0, r1, steps)
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


def _chunk_value_set(spec, c0: int, c1: int):
    """The chunk's non-null cells [c0, c1), or for a dictionary column the
    dictionary entries they use: the same min and max, from fewer values."""
    if spec.dict_encoded:
        return _take(spec.dictionary, np.unique(spec.indices[c0:c1]))
    return _slice(spec.values, c0, c1)


def _write_chunk(out, pos, spec, column, levels, r0, r1, steps):
    """Write one column chunk at file position `pos`: (ColumnChunk, bytes)."""
    step, plain_step = steps
    prefix = levels.cells
    buf = io.BytesIO()
    uncompressed = 0
    dict_offset = None
    encodings = {int(Encoding.RLE)} if levels.def_levels is not None else set()
    dict_size = None
    dictionary = spec.dictionary
    cells = spec.cells()
    lo, hi = int(prefix[r0]), int(prefix[r1])
    # rows [r0, fb_row) are dict-encoded; [fb_row, r1) PLAIN
    fb_row = r1
    if spec.dict_encoded and spec.dict_fallback_bytes is not None:
        dictionary, dict_cells, n_dict = _fallback_split(spec, spec.indices[lo:hi])
        if n_dict < hi - lo:
            fb_row = r0 + int(np.searchsorted(prefix[r0 : r1 + 1], lo + n_dict, side="left"))
        cells, lo = dict_cells, 0
    if spec.dict_encoded:
        header, block = encode_dict_page(column, dictionary, int(spec.codec))
        hbytes = header.dumps()
        dict_offset = pos
        buf.write(hbytes)
        buf.write(block)
        uncompressed += len(hbytes) + header.uncompressed_page_size
        encodings.add(int(Encoding.PLAIN))
        dict_size = len(dictionary)
    encodings.add(int(spec.encoding))
    data_offset = pos + buf.tell()
    encode = encode_data_page_v1 if spec.page_version == 1 else encode_data_page_v2
    pages = [(p0, min(fb_row, p0 + step), spec.encoding) for p0 in range(r0, fb_row, step)]
    if fb_row < r1:
        encodings.add(int(Encoding.PLAIN))
        pages += [
            (p0, min(r1, p0 + plain_step), Encoding.PLAIN)
            for p0 in range(fb_row, r1, plain_step)
        ]
    base = int(prefix[r0])
    for p0, p1, enc in pages:
        c0, c1 = int(prefix[p0]) - base, int(prefix[p1]) - base
        if enc == spec.encoding:
            page_cells = _slice(cells, lo + c0, lo + c1)
        else:  # PLAIN fallback: the cells' values
            page_cells = _take(spec.dictionary, spec.indices[base + c0 : base + c1])
        e0, e1 = int(levels.entries[p0]), int(levels.entries[p1])
        dfl = levels.def_levels[e0:e1] if levels.def_levels is not None else None
        rl = levels.rep_levels[e0:e1] if levels.rep_levels is not None else None
        header, block = encode(
            column, page_cells, dfl, rl, enc, int(spec.codec),
            dict_size if enc == spec.encoding else None,
        )
        hbytes = header.dumps()
        buf.write(hbytes)
        buf.write(block)
        uncompressed += len(hbytes) + header.uncompressed_page_size
    data = buf.getvalue()
    out.write(data)
    num_values = int(levels.entries[r1] - levels.entries[r0])
    c0, c1 = int(prefix[r0]), int(prefix[r1])
    md = ColumnMetaData(
        type=int(spec.type),
        encodings=sorted(encodings),
        path_in_schema=list(spec.path),
        codec=int(spec.codec),
        num_values=num_values,
        total_uncompressed_size=uncompressed,
        total_compressed_size=len(data),
        data_page_offset=data_offset,
        dictionary_page_offset=dict_offset,
        statistics=compute_statistics(
            spec.type, _chunk_value_set(spec, c0, c1), num_values - (c1 - c0),
            column_is_unsigned(column),
        ),
    )
    cc = ColumnChunk(
        file_offset=dict_offset if dict_offset is not None else data_offset,
        meta_data=md,
    )
    return cc, len(data)


# -- DELTA_BINARY_PACKED batches at the decode kernel's edges --------------------


class DeltaCase(NamedTuple):
    """The pages of one DELTA_BINARY_PACKED batch and the block layout they
    are encoded with (block_size values a block, mini_count miniblocks)."""

    label: str
    pages: list
    block_size: int
    mini_count: int


# miniblock length -> (block_size, mini_count)
DELTA_LAYOUTS = {8: (1024, 128), 32: (128, 4), 64: (128, 2), 128: (128, 1)}


def _delta_page(rng, dt, n: int, kind: int) -> np.ndarray:
    """n values of one kind: 0 full-range random (miniblock widths of the
    type's width, wrapping deltas), 1 monotone with negative jitter wrapping
    past the type's max, 2 a constant (width 0), 3 a narrow random walk."""
    info = np.iinfo(dt)
    if kind == 0:
        return rng.integers(info.min, info.max, size=n, dtype=dt, endpoint=True)
    if kind == 1:
        v = np.cumsum(rng.integers(-40, 900, size=n)) + int(info.max) - 20_000
        return v.astype(np.int64).astype(dt)
    if kind == 2:
        return np.full(n, -3, dtype=dt)
    return np.cumsum(rng.integers(-3, 4, size=n)).astype(dt)


def delta_edge_cases(nbits: int, tile: int, seed: int = 0) -> list:
    """DeltaCases at the edges of a DELTA decode that cuts its outputs into
    tiles of `tile` values: miniblocks of 8, 32, 64 and 128 values over
    pages of every kind (widths 0 and nbits among them) and a page holding
    only its first value; 300 pages of 1-700 values, 200 pages of 34-36
    values in 8-value miniblocks, 500 pages of 10-30 values and 2,000 pages
    of 1-3 values (tiles crossing many page starts and miniblocks, pages
    shorter than a tile); one
    page of 2**20 + 3 values; totals one below, at and one above a multiple
    of `tile`."""
    rng = np.random.default_rng(seed + nbits)
    dt = np.int32 if nbits == 32 else np.int64
    cases = []
    for mini_len, (block_size, mini_count) in DELTA_LAYOUTS.items():
        pages = [_delta_page(rng, dt, n, kind)
                 for n, kind in ((5000, 0), (3001, 1), (700, 2), (1, 0), (2500, 3))]
        cases.append(DeltaCase(f"miniblocks of {mini_len}", pages, block_size, mini_count))
    sizes = rng.integers(1, 701, size=300)
    cases.append(DeltaCase("300 pages of 1-700 values",
                           [_delta_page(rng, dt, int(n), k % 4) for k, n in enumerate(sizes)],
                           128, 4))
    sizes = rng.integers(34, 37, size=200)
    cases.append(DeltaCase("200 pages of 34-36 values in miniblocks of 8",
                           [_delta_page(rng, dt, int(n), k % 4) for k, n in enumerate(sizes)],
                           1024, 128))
    sizes = rng.integers(10, 31, size=500)
    cases.append(DeltaCase("500 pages of 10-30 values",
                           [_delta_page(rng, dt, int(n), k % 4) for k, n in enumerate(sizes)],
                           128, 4))
    sizes = rng.integers(1, 4, size=2000)
    cases.append(DeltaCase("2000 pages of 1-3 values",
                           [_delta_page(rng, dt, int(n), k % 4) for k, n in enumerate(sizes)],
                           1024, 128))
    big = (1 << 20) + 3
    walk = np.cumsum(rng.integers(-(1 << 20), 1 << 22, size=big)).astype(dt)
    walk[big // 3 : big // 3 + 4096] = _delta_page(rng, dt, 4096, 0)
    cases.append(DeltaCase("one page of 2**20 + 3 values", [walk], 128, 4))
    for d in (-1, 0, 1):
        total = 5 * tile + d
        cut = [0, tile // 3, 2 * tile + 5, total]
        pages = [_delta_page(rng, dt, b - a, k) for k, (a, b) in enumerate(zip(cut, cut[1:]))]
        cases.append(DeltaCase(f"total 5 x {tile} {d:+d}", pages, 128, 4))
    return cases


def freeze_delta_case(case: DeltaCase, nbits: int):
    """The case's pages encoded with the port's encode_delta, prescanned and
    frozen as one batch (kernels.pipeline._DeltaBatch): (frozen batch, the
    values it decodes to)."""
    from ..kernels.pipeline import _DeltaBatch
    from ..ops.delta import encode_delta, prescan_delta_packed

    batch = _DeltaBatch(nbits)
    for v in case.pages:
        stream = encode_delta(v, nbits, block_size=case.block_size, mini_count=case.mini_count)
        batch.add_page(prescan_delta_packed(stream, nbits, max_total=len(v)), stream)
    return batch.freeze(), np.concatenate(case.pages)


def delta_edge_batches(nbits: int, tile: int, seed: int = 0):
    """(label, frozen batch, values) for each of delta_edge_cases."""
    for case in delta_edge_cases(nbits, tile, seed):
        frozen, want = freeze_delta_case(case, nbits)
        yield case.label, frozen, want


# -- hybrid batches at the expansion kernel's edges ------------------------------


class HybridCase(NamedTuple):
    """The pages of one RLE/bit-packed hybrid batch at `width` bits: (stream,
    values) each, the stream holding exactly the runs the case names."""

    label: str
    width: int
    pages: list


def _hybrid_page(runs, width: int) -> tuple[bytes, np.ndarray]:
    """A hybrid stream of `runs`, each ("rle", count, value) or ("bp",
    values), and the values it holds. A bit-packed run is zero-padded to
    whole groups of 8 in the stream; only a page's last run may hold a count
    that is not a multiple of 8 (the page's value count cuts it short)."""
    from ..ops.bitpack import pack_bits
    from ..ops.varint import emit_uvarint

    out = bytearray()
    vals = []
    for k, run in enumerate(runs):
        if run[0] == "rle":
            _kind, count, value = run
            emit_uvarint(out, count << 1)
            out += int(value).to_bytes((width + 7) // 8, "little")
            vals.append(np.full(count, value, dtype=np.uint64))
        else:
            v = np.asarray(run[1], dtype=np.uint64)
            if len(v) % 8 and k != len(runs) - 1:
                raise ValueError("hybrid: only a page's last bit-packed run may be cut short")
            padded = np.concatenate([v, np.zeros(-len(v) % 8, dtype=np.uint64)])
            emit_uvarint(out, (len(padded) // 8) << 1 | 1)
            out += pack_bits(padded, width)
            vals.append(v)
    return bytes(out), np.concatenate(vals).astype(np.uint32)


# the widths hybrid_edge_cases is run at: none, one bit, and the widest
HYBRID_EDGE_WIDTHS = (0, 1, 31, 32)


def hybrid_edge_cases(width: int, tile: int, seed: int = 0) -> list:
    """HybridCases at the edges of a hybrid expansion that cuts its outputs
    into tiles of `tile` values: RLE runs of length 1-17 among bit-packed
    runs of 32-96 values; one RLE run over five tiles; pages whose last
    bit-packed run is cut short (1, 7, 1,001 and tile + 5 values); 8-value
    RLE and bit-packed runs alternating (a tile spans tile / 8 + 1 runs,
    more than the kernel stages); totals of 1, tile - 1, tile and tile + 1."""
    rng = np.random.default_rng(seed + width)

    def vals(n):
        if width == 0:
            return np.zeros(n, dtype=np.uint64)
        return rng.integers(0, 1 << width, size=n, dtype=np.uint64)

    def one():
        return int(vals(1)[0])

    cases = []
    runs = []
    for _ in range(600):
        if rng.random() < 0.5:
            runs.append(("rle", int(rng.choice([1, 1, 1, 2, 3, 5, 9, 17])), one()))
        else:
            runs.append(("bp", vals(8 * int(rng.integers(4, 13)))))
    cases.append(HybridCase("RLE runs of 1-17 values", width, [_hybrid_page(runs, width)]))
    cases.append(HybridCase(
        "one RLE run over five tiles", width,
        [_hybrid_page([("bp", vals(16)), ("rle", 5 * tile + 3, one()), ("bp", vals(13))], width)],
    ))
    cases.append(HybridCase("bit-packed last runs cut short", width, [
        _hybrid_page([("bp", vals(1001))], width),
        _hybrid_page([("rle", 20, one()), ("bp", vals(7))], width),
        _hybrid_page([("bp", vals(1))], width),
        _hybrid_page([("rle", 3, one()), ("bp", vals(tile + 5))], width),
    ]))
    pairs = 3 * tile // 16
    # (a 3-value run first: every tile then spans tile / 8 + 1 runs)
    alternating = [("rle", 3, one())] + [
        run for _ in range(pairs) for run in (("rle", 8, one()), ("bp", vals(8)))]
    cases.append(HybridCase("8-value RLE and bit-packed runs alternating", width,
                            [_hybrid_page(alternating, width), _hybrid_page(alternating, width)]))
    cases.append(HybridCase("total 1", width, [_hybrid_page([("bp", vals(1))], width)]))
    for d in (-1, 0, 1):
        rest = tile // 2 - 100 + d
        runs = [("bp", vals(tile // 2)), ("rle", 100, one()), ("bp", vals(rest))]
        cases.append(HybridCase(f"total {tile} {d:+d}", width, [_hybrid_page(runs, width)]))
    return cases


def freeze_hybrid_case(case: HybridCase):
    """The case's pages prescanned with the port's prescan_hybrid and frozen
    as one batch (kernels.pipeline._HybridBatch): (frozen batch, the values
    it expands to; zeros at width 0)."""
    from ..kernels.pipeline import _HybridBatch
    from ..ops.rle_hybrid import prescan_hybrid

    batch = _HybridBatch(case.width)
    for stream, v in case.pages:
        batch.add_page(prescan_hybrid(stream, len(v), case.width), len(v))
    return batch.freeze(), np.concatenate([v for _s, v in case.pages])


def most_runs_a_tile(frozen, tile: int) -> int:
    """The most runs that one tile of `tile` consecutive outputs of a frozen
    hybrid batch spans."""
    starts = frozen.buf[frozen.run_pad : 2 * frozen.run_pad].view(np.int32)
    first = np.arange(0, frozen.total, tile)
    last = np.minimum(first + tile, frozen.total) - 1
    return int((np.searchsorted(starts, last, "right")
                - np.searchsorted(starts, first, "right") + 1).max())


def hybrid_edge_batches(width: int, tile: int, seed: int = 0):
    """(label, frozen batch, values) for each of hybrid_edge_cases."""
    for case in hybrid_edge_cases(width, tile, seed):
        frozen, want = freeze_hybrid_case(case)
        yield case.label, frozen, want


# -- mixed dict/PLAIN byte-array chunks at the merge kernel's edges ---------------


class MixedBytesCase(NamedTuple):
    """A mixed byte-array chunk: its dictionary and its pages, each ("dict",
    int32 indices) or ("plain", ByteArrayData)."""

    label: str
    dictionary: ByteArrayData
    pages: list


def out_of_range_indices(n_dict: int) -> tuple:
    """Dictionary indices a chunk may carry that lie outside its dictionary
    of n_dict entries."""
    return (-1, n_dict, n_dict + 1, 2**31 - 1)


def mixed_bytes_args(case: MixedBytesCase) -> tuple:
    """The merge_mixed_bytes arguments of a case, as the pipeline builds
    them (kernels.pipeline._page_merge_tables; the pool is the dictionary's
    payload followed by every PLAIN page's): (idx_all, doff, pool, po32,
    page_kind, page_row_start, page_aux, page_src_base) as NumPy arrays,
    then n_rows and the byte bound."""
    from ..kernels.pipeline import _page_merge_tables, _skewed_dict_bound

    d = case.dictionary
    infos = [(len(p), None, None, "dict", len(p)) if kind == "dict"
             else (len(p.offsets) - 1, None, None, "values", p) for kind, p in case.pages]
    kind, prs, aux, n_rows = _page_merge_tables(
        infos, lambda p: (len(p.offsets), len(p.offsets) - 1)
    )
    pools, src_base, po, base = [np.frombuffer(d.data, np.uint8)], [], [], len(d.data)
    for k, p in case.pages:
        if k == "dict":
            src_base.append(0)
        else:
            src_base.append(base)
            po.append(np.asarray(p.offsets, np.int32))
            pools.append(np.frombuffer(p.data, np.uint8))
            base += len(p.data)
    srcb = np.zeros(len(kind), np.int64)
    srcb[: len(src_base)] = src_base
    idx = [np.asarray(p, np.int32) for k, p in case.pages if k == "dict"]
    dict_rows = sum(len(p) for p in idx)
    bound, _ok = _skewed_dict_bound(d, dict_rows, base - len(d.data))
    pool = np.concatenate(pools)
    return (
        np.concatenate(idx) if idx else np.zeros(0, np.int32),
        np.asarray(d.offsets, np.int64),
        pool if len(pool) else np.zeros(1, np.uint8),
        np.concatenate(po) if po else np.zeros(2, np.int32),
        kind, prs, aux, srcb, n_rows, bound,
    )


def mixed_bytes_edge_cases(tile: int, seed: int = 0) -> list:
    """MixedBytesCases at the edges of a merge that cuts its rows into tiles
    of `tile` rows and copies 16-byte chunks: PLAIN rows of 100 KiB and more;
    all-empty rows, and a tile whose rows are all empty; row counts of tile
    - 1, tile, tile + 1 and 3 x tile + 1; the out-of-range dictionary
    indices at row 0 and across a tile boundary; lengths of 15-17, 31-33 and
    47-49 bytes."""
    rng = np.random.default_rng(seed)

    def words(lengths, letter=b"a"):
        return ByteArrayData.from_list(
            [bytes(rng.integers(letter[0], letter[0] + 26, size=int(k), dtype=np.uint8))
             for k in lengths])

    def idx(n, n_dict):
        return rng.integers(0, n_dict, size=n).astype(np.int32)

    small = words(rng.integers(0, 21, size=1000))
    cases = [MixedBytesCase("PLAIN rows of 100 KiB and more", small, [
        ("dict", idx(tile - 2, 1000)),
        ("plain", words([150_000, 3, 0, 102_400, 17, 131_073], b"A")),
        ("dict", idx(5, 1000)),
        ("plain", words([100 << 10, 1], b"A")),
    ])]
    empty = ByteArrayData.from_list([b""] * 7)
    cases.append(MixedBytesCase("all rows empty", empty, [
        ("dict", idx(2 * tile + 5, 7)), ("plain", words([0] * tile)),
    ]))
    with_empty = words([0] + [int(k) for k in rng.integers(1, 21, size=99)])
    cases.append(MixedBytesCase("a tile of empty rows", with_empty, [
        ("plain", words(rng.integers(0, 31, size=tile), b"A")),
        ("dict", np.zeros(tile, np.int32)),
        ("dict", idx(tile // 2, 100)),
    ]))
    for n in (tile - 1, tile, tile + 1, 3 * tile + 1):
        cut = sorted(rng.integers(0, n, size=3))
        sizes = np.diff([0, *cut, n])
        pages = [("dict", idx(int(s), 1000)) if k % 2 == 0
                 else ("plain", words(rng.integers(0, 41, size=int(s)), b"A"))
                 for k, s in enumerate(sizes)]
        cases.append(MixedBytesCase(f"{n} rows", small, pages))
    bad = np.array(out_of_range_indices(1000), np.int32)
    first = idx(tile + 2, 1000)
    first[:4] = bad
    first[tile - 2 : tile + 2] = bad
    cases.append(MixedBytesCase("out-of-range indices", small, [
        ("dict", first), ("plain", words(rng.integers(0, 41, size=300), b"A")),
        ("dict", idx(700, 1000)),
    ]))
    near16 = words(rng.choice([1, 15, 16, 17, 31, 32, 33], size=500))
    cases.append(MixedBytesCase("lengths around multiples of 16", near16, [
        ("plain", words(rng.choice([0, 15, 16, 17, 47, 48, 49], size=tile + 7), b"A")),
        ("dict", idx(tile, 500)),
        ("plain", words(rng.choice([1, 15, 16, 17], size=3 * tile), b"A")),
        ("dict", idx(2 * tile + 3, 500)),
    ]))
    return cases


# -- ragged paddings at the padding kernel's edges --------------------------------


class PadCase(NamedTuple):
    """One pad_ragged call: flat values, per-row lengths and the row width."""

    label: str
    values: np.ndarray
    lengths: np.ndarray
    max_len: int


def pad_ragged_wide(max_len: int, elem_bytes: int) -> bool:
    """Whether the padding kernel writes these rows in spans (wide_rows of
    kernels/csrc/pad_ragged.cu): a row's output exceeds
    PAD_RAGGED_TILE_BYTES, and each block writes one such span of the
    output, crossing at most one row's end."""
    from ..kernels.device_ops import PAD_RAGGED_TILE_BYTES

    return max_len * elem_bytes > PAD_RAGGED_TILE_BYTES


def pad_ragged_tile_rows(max_len: int, elem_bytes: int) -> int:
    """Rows a tile of the padding kernel takes (tile_rows_for of
    kernels/csrc/pad_ragged.cu): PAD_RAGGED_TILE, or fewer when a row's
    output is wide, a multiple of 16 and at least 16; PAD_RAGGED_TILE again
    for rows written in spans (pad_ragged_wide), whose tiles only carry
    length sums."""
    from ..kernels.device_ops import PAD_RAGGED_TILE, PAD_RAGGED_TILE_BYTES

    if pad_ragged_wide(max_len, elem_bytes):
        return PAD_RAGGED_TILE
    row_bytes = max_len * elem_bytes
    t = PAD_RAGGED_TILE_BYTES // row_bytes if row_bytes else PAD_RAGGED_TILE
    return min(max(t // 16 * 16, 16), PAD_RAGGED_TILE)


def pad_ragged_edge_cases(seed: int = 0) -> list:
    """PadCases at the edges of a padding that cuts its rows into tiles
    (pad_ragged_tile_rows): row counts of tile - 1,
    tile, tile + 1 and 3 x tile + 1; a negative length at a tile's first and
    at its last row; rows longer than max_len, and far longer; lengths near
    2**30 whose int32 offsets wrap negative and clip (and, for int64
    lengths, lengths past int32 whose cast differs from the compare); nv 0
    and fewer values than the lengths ask ("over"); max_len 0, 1, 16 and
    2,500; rows wider than PAD_RAGGED_TILE_BYTES (written in spans that
    cross row ends), with a length near 2**30 among them; 1-, 4- and 8-byte
    elements, int32 and int64 lengths."""
    from ..kernels.device_ops import PAD_RAGGED_TILE_BYTES

    rng = np.random.default_rng(seed)
    cases = []

    def vals(nv, dt):
        info = np.iinfo(dt)
        return rng.integers(info.min, info.max, nv, dtype=dt, endpoint=True)

    for dt in (np.uint8, np.int32, np.int64):
        e = np.dtype(dt).itemsize
        for ldt in (np.int32, np.int64):
            tag = f"{np.dtype(dt).name} values, {np.dtype(ldt).name} lengths"

            def case(label, lengths, max_len, nv=None):
                ln = np.asarray(lengths).astype(ldt)
                if nv is None:
                    nv = max(int(np.clip(ln.astype(np.int64), 0, None).sum()), 0)
                cases.append(PadCase(f"{label}, {tag}", vals(nv, dt), ln, max_len))

            t = pad_ragged_tile_rows(16, e)
            for n in (t - 1, t, t + 1, 3 * t + 1):
                # lengths up to 20: some rows are longer than max_len
                case(f"rows={n} (tile {t}) max_len=16", rng.integers(0, 21, n), 16)
            ln = rng.integers(0, 17, 2 * t + 5)
            ln[t], ln[2 * t - 1] = -5, -3  # a tile's first row and its last
            case("negative lengths at a tile's first and last row", ln, 16)
            ln = rng.integers(0, 9, 2 * t)
            ln[[3, t + 7, t + 8]] = 5000
            case("rows far longer than max_len", ln, 16)
            ln = rng.integers(0, 9, t + 40)
            ln[[2, 3, 4, t + 1]] = (2**30, 2**30, 2**30 - 1, 2**30 + 7)
            case("lengths near 2**30: int32 offsets wrap and clip", ln, 16, nv=1000)
            if ldt is np.int64:
                ln = rng.integers(0, 9, t + 3).astype(np.int64)
                ln[[1, 5, t]] = (2**32 + 3, -(2**32) + 2, 2**31)
                case("lengths past int32", ln, 16, nv=3000)
            case("nv=0", rng.integers(0, 17, t + 9), 16, nv=0)
            case("nv over", rng.integers(0, 17, 3 * t + 1), 16, nv=t)
            for max_len in (0, 1):
                case(f"max_len={max_len}", rng.integers(0, 3, t + 5), max_len)
            w = pad_ragged_tile_rows(2500, e)
            case(f"max_len=2500 (tile {w})", rng.integers(0, 3001, 3 * w + 5), 2500)
            # rows of 1.5 spans, so the spans cross row ends at every phase
            wide = 3 * PAD_RAGGED_TILE_BYTES // (2 * e) + 3
            ln = rng.integers(0, wide + 50, 9)
            ln[[2, 6]] = (wide, -4)
            case(f"max_len={wide} (spans)", ln, wide)
            ln[4] = 2**30 + 5
            case(f"max_len={wide} (spans), a length near 2**30", ln, wide, nv=3 * wide)
    return cases


# -- repetition levels at the record-start kernel's edges -------------------------


def record_starts_edge_cases(tile: int, seed: int = 0) -> list:
    """(label, int32 repetition levels) at the edges of a record-start scan
    over tiles of `tile` entries: n = 0, 1, tile - 1, tile, tile + 1;
    leading non-starts longer than a tile; a tile with no record start; a
    tile of starts only; levels 0-3 at random over several tiles."""
    rng = np.random.default_rng(seed)
    cases = []

    def levels(n):
        rep = rng.integers(1, 4, n).astype(np.int32)
        rep[rng.random(n) < 0.3] = 0
        return rep

    for n in (0, 1, tile - 1, tile, tile + 1):
        cases.append((f"n={n}", levels(n)))
    cases.append(("n=1, not a start", np.ones(1, np.int32)))
    rep = levels(3 * tile + 5)
    rep[: tile + 37] = 2
    cases.append(("leading non-starts longer than a tile", rep))
    rep = levels(3 * tile + 11)
    rep[tile - 3 : 2 * tile + 5] = 1
    cases.append(("a tile with no record start", rep))
    rep = levels(3 * tile + 2)
    rep[tile : 2 * tile] = 0
    cases.append(("a tile of starts only", rep))
    cases.append(("levels 0-3 over five tiles", rng.integers(0, 4, 5 * tile - 7).astype(np.int32)))
    return cases


# -- level streams at the list-layout kernel's edges -----------------------------


def list_layout_edge_cases(tile: int, seed: int = 0) -> list:
    """(label, int32 rep levels, int32 def levels, parent_rep, elem_def) at
    the edges of a list-layout scan over tiles of `tile` entries in 4-entry
    vectors: n = 0, 1, tile - 1, tile and tile + 1; boundaries (rep <=
    parent_rep) as the first and the last entry of a tile and of a vector;
    a tile with no boundary and one of boundaries only; a stream of
    boundaries only (n_slots = n); leading non-boundaries longer than a
    tile; no boundary at all; a tail (the entries from n_slots on) that
    starts in the first tile and one that starts in the last; levels 0-3
    at parent_rep 1 over several tiles."""
    rng = np.random.default_rng(seed)
    cases = []
    t = tile

    def levels(n, p_boundary=0.3):
        rep = rng.integers(1, 3, n).astype(np.int32)
        rep[rng.random(n) < p_boundary] = 0
        return rep, rng.integers(0, 4, n).astype(np.int32)

    def case(label, rep, dfl, parent_rep=0, elem_def=2):
        cases.append((label, rep, dfl, parent_rep, elem_def))

    for n in (0, 1, t - 1, t, t + 1):
        case(f"n={n}", *levels(n))
    case("n=1, not a boundary", np.ones(1, np.int32), np.full(1, 3, np.int32))
    rep, dfl = levels(3 * t + 5, 0.0)
    rep[[t - 1, t, 2 * t - 1, 2 * t, 4 * 9, 4 * 11 + 3, t + 4 * 5, t + 4 * 7 + 3]] = 0
    case("boundaries first and last in tiles and vectors", rep, dfl)
    rep, dfl = levels(3 * t + 11)
    rep[t - 3 : 2 * t + 5] = 1
    case("a tile with no boundary", rep, dfl)
    rep, dfl = levels(3 * t + 2)
    rep[t : 2 * t] = 0
    case("a tile of boundaries only", rep, dfl)
    case("boundaries only (n_slots = n)", np.zeros(2 * t + 3, np.int32),
         rng.integers(0, 4, 2 * t + 3).astype(np.int32))
    rep, dfl = levels(3 * t + 5)
    rep[: t + 37] = 2
    case("leading non-boundaries longer than a tile", rep, dfl)
    case("no boundary at all", *levels(2 * t + 9, 0.0))
    rep, dfl = levels(3 * t + 1, 0.0)
    rep[rng.choice(t // 2, 40, replace=False)] = 0
    case("a tail starting in the first tile", rep, dfl)
    rep = np.zeros(3 * t + 100, np.int32)
    rep[rng.choice(len(rep), 50, replace=False)] = 1
    case("a tail starting in the last tile", rep, rng.integers(0, 4, len(rep)).astype(np.int32))
    case("levels 0-3 at parent_rep 1 over five tiles",
         rng.integers(0, 4, 5 * t - 7).astype(np.int32),
         rng.integers(0, 5, 5 * t - 7).astype(np.int32), 1, 3)
    return cases


# -- level streams at the LIST-contains kernel's edges ---------------------------


def list_contains_edge_cases(tile: int, seed: int = 0) -> list:
    """(label, int32 rep levels, int32 def levels, bool dense_match,
    elem_def) at the edges of a LIST-contains scan over tiles of `tile`
    entries in 4-entry vectors, whose epilogue marks a warp's rows of 128
    entries: n = 0, 1, tile - 1, tile and tile + 1; record starts (rep == 0)
    as the first and the last entry of a tile and of a vector; a record
    longer than a tile that matches only in its second tile; matching
    entries before the first record start (they clip into row 0); no record
    start at all; starts only (n_rows = n) with every element matching, so
    a warp marks 128 rows; nv = 0, nv past the element count and a stream
    of one element; the saturated elem_def 2**31 - 1 (no def stream)."""
    rng = np.random.default_rng(seed)
    cases = []
    t = tile

    def levels(n, p_start=0.3):
        rep = rng.integers(1, 3, n).astype(np.int32)
        rep[rng.random(n) < p_start] = 0
        # 0 a null list, 1 an empty one, 2 an element
        dfl = rng.choice(np.array([0, 1, 2], np.int32), n, p=(0.05, 0.05, 0.9))
        return rep, dfl

    def case(label, rep, dfl, dm=None, p=0.3, elem_def=2):
        if dm is None:
            dm = rng.random(int((dfl == elem_def).sum())) < p
        cases.append((label, rep, dfl, np.asarray(dm, dtype=bool), elem_def))

    for n in (0, 1, t - 1, t, t + 1):
        case(f"n={n}", *levels(n))
    rep, dfl = levels(3 * t + 5, 0.0)
    rep[[0, t - 1, t, 2 * t - 1, 2 * t, 4 * 9, 4 * 11 + 3, t + 4 * 5, t + 4 * 7 + 3]] = 0
    case("starts first and last in tiles and vectors", rep, dfl)
    # one record from entry 5 over two tiles; its only match lies in the
    # second tile, and the records after it match nowhere
    rep, dfl = levels(3 * t, 0.3)
    rep[5 : 2 * t + 50] = 1
    rep[5] = 0
    dfl[5 : 2 * t + 50] = 2
    elems = np.cumsum(dfl == 2) - 1
    dm = np.zeros(int((dfl == 2).sum()), bool)
    dm[elems[t + 300]] = True
    case("a record over two tiles matching only in the second", rep, dfl, dm)
    rep, dfl = levels(2 * t + 3)
    rep[:200] = 1
    dfl[:200] = 2
    dm = rng.random(int((dfl == 2).sum())) < 0.3
    dm[:200:7] = True
    case("matches before the first record start", rep, dfl, dm)
    case("no record start at all", *levels(2 * t + 9, 0.0), p=0.5)
    rep = np.zeros(2 * t + 3, np.int32)
    dfl = rng.choice(np.array([1, 2], np.int32), len(rep), p=(0.1, 0.9))
    dfl[:512] = 2  # the first warps' rows all match
    case("starts only (n_rows = n), every element matching", rep, dfl, p=1.0)
    rep, dfl = levels(t + 17)
    case("nv = 0", rep, dfl, np.zeros(0, bool))
    rep, dfl = levels(t + 17)
    case("nv past the element count", rep, dfl, rng.random(int((dfl == 2).sum()) + 50) < 0.3)
    rep, dfl = levels(t + 17)
    dfl[:] = 1
    dfl[t - 3] = 2
    case("one element", rep, dfl, np.ones(1, bool))
    rep, _ = levels(2 * t + 1)
    case("saturated elem_def 2**31 - 1", rep, np.full(len(rep), 2**31 - 1, np.int32),
         rng.random(len(rep)) < 0.2, elem_def=2**31 - 1)
    return cases


# -- verdicts at the leaf-verdict kernel's edges ----------------------------------


def leaf_verdict_edge_cases(tile: int, seed: int = 0, group: int = 0) -> list:
    """(label, uint8 verdict, int32 indices or None, bool validity or None,
    fill) at the edges of a leaf verdict whose threads take 16 rows and
    whose validity path counts tiles of `tile` rows (and, past `group`
    tiles, groups of them): n = 0, 1, 15, 16, 17, tile - 1, tile, tile + 1
    and 3 x tile + 5; with `group`, n = group x tile (one whole group),
    group x tile + 1 and 2 x group x tile + tile + 3; all-true, all-false and
    random validities; nd = 0; `fill` both ways; out-of-range indices (-1,
    n_dict, -n_dict - 4) on both sides of a tile boundary, with and without
    a validity; a dense verdict and one through indices; verdict bytes
    other than 0 and 1 (any nonzero byte is true)."""
    rng = np.random.default_rng(seed)
    cases = []
    t = tile
    n_dict = 1000

    def verdict(m):
        v = rng.integers(0, 2, m).astype(np.uint8)
        # nonzero bytes other than 1 on a third of the true entries
        high = (v == 1) & (rng.random(m) < 0.33)
        v[high] = rng.integers(2, 256, int(high.sum()), dtype=np.uint8)
        return v

    def case(label, n, p=0.7, dense=False, valid=True, idx_at=(), n_dict=n_dict):
        val = rng.random(n) < p if valid else None
        nd = n if val is None else int(val.sum())
        if dense:
            v, idx = verdict(nd), None
        else:
            v = verdict(n_dict)
            idx = rng.integers(0, n_dict, nd).astype(np.int32)
            # out-of-range indices at the dense positions of rows idx_at
            dense_at = idx_at if val is None else (np.cumsum(val) - 1)[list(idx_at)]
            for k, x in zip(dense_at, (-1, n_dict, -n_dict - 4) * 2, strict=False):
                if 0 <= k < nd:
                    idx[k] = x
        for fill in (False, True) if val is not None else (False,):
            cases.append((f"{label}, fill={fill}", v, idx, val, fill))

    for n in (0, 1, 15, 16, 17, t - 1, t, t + 1, 3 * t + 5):
        case(f"n={n}, random validity", n)
        case(f"n={n}, no validity", n, valid=False)
    edge = (t - 3, t - 2, t - 1, t, t + 1, t + 2)
    case("out-of-range indices around a tile boundary", 3 * t, p=1.0, idx_at=edge)
    case("out-of-range indices around a tile boundary, no validity", 3 * t, valid=False,
         idx_at=edge)
    case("out-of-range indices with nulls", 3 * t, p=0.5, idx_at=edge)
    case("all valid", 2 * t + 7, p=1.0)
    case("all null (nd = 0)", 2 * t + 7, p=0.0)
    case("nd = 0, one row", 1, p=0.0)
    case("dense verdict, random validity", 2 * t + 7, dense=True)
    case("dense verdict, all valid", t + 1, p=1.0, dense=True)
    case("dense verdict, no validity", 2 * t + 7, dense=True, valid=False)
    if group:
        g = group * t
        case(f"n={g}: one whole group of tiles", g, p=0.9)
        case(f"n={g + 1}: a tile past one group", g + 1, p=0.9, idx_at=(g - 1, g))
        case(f"n={2 * g + t + 3}: past two groups", 2 * g + t + 3, p=0.5, dense=True)
    return cases


# -- pages at the DELTA encode kernel's tile edges ---------------------------------


def delta_encode_edge_cases(tile: int, seed: int = 0) -> list:
    """(label, int32 or int64 values) of one DELTA page each at the edges of
    an encode over tiles of `tile` deltas (tile / 128 blocks of 128):
    n = 2; block counts of G k - 1, G k and G k + 1 (G blocks a tile); n - 1
    not a multiple of 128; an all-constant tile (payload 0) between wide
    ones; miniblock widths 32 and 64 in one tile; the write path's page
    sizes (131,072 int64 timestamps, 262,144 int32 fares); 2**20 + 3
    values; and a page of 257 tiles (past one round of 256)."""
    rng = np.random.default_rng(seed)
    g = tile // 128
    cases = []

    def full(n, dt):
        info = np.iinfo(dt)
        return rng.integers(info.min, info.max, n, dtype=dt, endpoint=True)

    def rising(n, dt):
        return np.cumsum(rng.integers(-50, 3000, n)).astype(dt)

    for dt in (np.int32, np.int64):
        name = np.dtype(dt).name
        cases.append((f"n=2 {name}", full(2, dt)))
        for nb in (2 * g - 1, 2 * g, 2 * g + 1):
            cases.append((f"{nb} blocks {name}", rising(128 * nb + 1, dt)))
        cases.append((f"n - 1 = {256 * g + 77} {name}", full(256 * g + 78, dt)))
        v = full(3 * tile + 1, dt)
        v[tile : 2 * tile + 1] = v[tile]
        cases.append((f"an all-constant tile between wide ones {name}", v))
    # block 0 of tile 1 spans all 64 bits, block 1 exactly 32
    d = rng.integers(0, 1 << 20, 3 * tile, dtype=np.uint64)
    d[tile : tile + 128] = rng.integers(0, 2**64 - 1, 128, dtype=np.uint64, endpoint=True)
    d[tile + 128 : tile + 256] = rng.integers(0, 2**32 - 1, 128, dtype=np.uint64, endpoint=True)
    d[tile + 128], d[tile + 129] = 0, 2**32 - 1
    v = np.cumsum(np.concatenate([np.zeros(1, np.uint64), d]), dtype=np.uint64).view(np.int64)
    cases.append(("widths 32 and 64 in one tile int64", v))
    d = rng.integers(0, 1 << 10, 2 * tile, dtype=np.uint64).astype(np.uint32)
    d[tile + 200 : tile + 232] = rng.integers(0, 2**32 - 1, 32, dtype=np.uint64, endpoint=True)
    d[tile + 200], d[tile + 201] = 0, 2**32 - 1
    v = np.cumsum(np.concatenate([np.zeros(1, np.uint32), d]), dtype=np.uint32).view(np.int32)
    cases.append(("width 32 beside narrow ones in one tile int32", v))
    pickup = 1_700_000_000_000_000 + np.cumsum(rng.integers(-2_000_000, 60_000_000, 1 << 17))
    cases.append(("131,072 int64 timestamps (a write page)", pickup.astype(np.int64)))
    fare = rng.gamma(2.0, 900.0, 1 << 18).astype(np.int32) + 250
    cases.append(("262,144 int32 fares (a write page)", fare))
    cases.append(("2**20 + 3 int64", rising((1 << 20) + 3, np.int64)))
    cases.append(("257 tiles int32", full(256 * tile + 2, np.int32)))
    return cases


# -- run plans at the hybrid encode's tile edges ----------------------------------


def rle_plan_edge_cases(tile: int, seed: int = 0) -> list:
    """(label, uint32 values, width) at the edges of a run plan over tiles of
    `tile` values (8-aligned RLE windows of >= 8 equal values): n = 0, 1,
    tile - 1, tile, tile + 1; one run over several whole tiles; a run
    ending exactly at a tile's edge; an RLE window straddling a tile's
    edge; adjacent windows of different runs across a tile's edge;
    alternating values; all-equal values longer than a tile; widths 1, 3,
    12 and 32."""
    rng = np.random.default_rng(seed)
    cases = []

    def runs(lengths, width):
        keys = rng.integers(0, 1 << width, len(lengths), dtype=np.uint64)
        # neighbouring runs differ
        for k in range(1, len(keys)):
            if keys[k] == keys[k - 1]:
                keys[k] ^= np.uint64(1)
        return np.repeat(keys, lengths).astype(np.uint32)

    def mixed(n, width):
        return runs(rng.integers(1, 20, n // 6 + 1), width)[:n]

    for n, width in ((0, 3), (1, 3), (tile - 1, 12), (tile, 1), (tile + 1, 32)):
        cases.append((f"n={n}, width {width}", mixed(n, width), width))
    t = tile
    cases.append(("one run over three whole tiles, width 3", runs([t - 5, 3 * t + 9, 17, t], 3), 3))
    cases.append(("a run ending at a tile's edge, width 12", runs([t - 20, 20, 3, t - 3], 12), 12))
    # the window [t - 8, t + 8) of the run [t - 9, t + 10)
    cases.append(("a window straddling a tile's edge, width 3", runs([t - 9, 19, t - 10], 3), 3))
    # the windows [t - 16, t) and [t, t + 16) of two runs
    cases.append(("adjacent windows of two runs across a tile's edge, width 32",
                  runs([t - 16, 16, 16, t - 16], 32), 32))
    cases.append(("alternating values, width 1", (np.arange(2 * t + 3) % 2).astype(np.uint32), 1))
    cases.append(("all equal over 2.5 tiles, width 12", np.full(5 * t // 2, 4000, np.uint32), 12))
    # the pack inside the placement: each tile's compacted range as bits of
    # the packed words, at widths that put its ends mid-word
    for width in (7, 17, 31):
        cases.append((f"n={3 * t + 5}, width {width}", mixed(3 * t + 5, width), width))
    # tile 0 keeps t - 8 values (one 8-value window): tile 1's range starts
    # mid-word; tile 1 keeps 16 (13 single values, then the 3 before the
    # window [t + 16, 2t) of the run [t + 13, 2t + 6)) and ends mid-word
    short0 = [3] * ((t - 8) // 3) + [(t - 8) % 3] * ((t - 8) % 3 > 0)
    cases.append(("a tile's packed range starting and ending mid-word, width 7",
                  runs([8] + short0 + [1] * 13 + [t - 7] + [3] * (t // 3), 7), 7))
    # tile 1 lies in the window [t, 2t) of the run [t - 3, 2t + 5): tile 0
    # keeps t - 8 values and tile 2 goes on in the packed word tile 0 ends in
    short1 = [5] * ((t - 11) // 5) + [(t - 11) % 5] * ((t - 11) % 5 > 0)
    cases.append(("an all-RLE tile between two tiles that share a packed word, width 17",
                  runs([8] + short1 + [t + 8] + [3] * (t // 3), 17), 17))
    # nothing in an RLE window: every value packed, 17 groups of tiles
    cases.append(("every value kept over 2**22 + 777 values, width 31",
                  runs(np.full(((1 << 22) + 777 + 6) // 7, 7), 31)[: (1 << 22) + 777], 31))
    return cases


# -- bit-packs at the pack kernel's tile edges --------------------------------------


def bitpack_edge_cases(tile: int, seed: int = 0) -> list:
    """(label, uint32 values, width) for a bit-pack over tiles of `tile`
    values: n = 0, 1, 7, 8, 31, 32, 33, tile - 1, tile, tile + 1 and
    3 * tile + 5 at widths 0, 1, 3, 7, 12, 17, 31 and 32. The values are
    not masked: a quarter are 2**width - 1, a quarter 2**width exactly and
    the rest at random over all 32 bits, so the pack must mask them."""
    rng = np.random.default_rng(seed)
    cases = []
    for n in (0, 1, 7, 8, 31, 32, 33, tile - 1, tile, tile + 1, 3 * tile + 5):
        for width in (0, 1, 3, 7, 12, 17, 31, 32):
            v = rng.integers(0, 1 << 32, n, dtype=np.uint64)
            v[rng.random(n) < 0.25] = (1 << width) - 1
            v[rng.random(n) < 0.25] = (1 << width) & 0xFFFFFFFF
            cases.append((f"n={n}, width {width}", v.astype(np.uint32), width))
    return cases


# -- BYTE_STREAM_SPLIT chunks of pages ----------------------------------------------


def bss_pages_cases(seed: int = 0) -> list:
    """(label, [(uint8 (4, n_pad) streams, num_values), ...]) chunks for the
    BYTE_STREAM_SPLIT de-interleave, each page's streams padded to the
    pipeline's power-of-two bucket (>= 1,024) with random bytes: one-page
    chunks of 0-17, 1,023, 1,024 and 1,025 values; chunks of 1, 2 and 5
    pages whose pages start at output offsets that are not multiples of 4;
    150 pages (more than one launch's page table of 64); and one page
    whose streams are not padded (n_pad = num_values = 1,027, rows off 4
    bytes)."""
    rng = np.random.default_rng(seed)

    def page(nv, n_pad=None):
        n_pad = n_pad or max(1024, 1 << max(nv - 1, 0).bit_length())
        return rng.integers(0, 256, (4, n_pad), dtype=np.uint8), nv

    cases = [(f"one page of {nv}", [page(nv)]) for nv in (*range(18), 1023, 1024, 1025)]
    cases.append(("1 page of 1,021 values", [page(1021)]))
    cases.append(("2 pages of 1,021 and 2,050 values", [page(1021), page(2050)]))
    cases.append(("5 pages of 5, 1,027, 3, 4,097 and 1,030 values",
                  [page(nv) for nv in (5, 1027, 3, 4097, 1030)]))
    cases.append(("150 pages of 0-3,000 values",
                  [page(int(nv)) for nv in rng.integers(0, 3000, 150)]))
    cases.append(("1 unpadded page of 1,027 values (n_pad 1,027)", [page(1027, 1027)]))
    return cases


# -- dictionary probes at the probe kernel's edges --------------------------------


def dict_indices_edge_cases(tile: int, seed: int = 0) -> list:
    """(label, bit patterns) at the edges of a first-occurrence probe that
    dedupes tiles of `tile` rows in warps of 32: sizes of tile - 1, tile and
    tile + 1; one key over 2**20 rows; two keys alternating across warp and
    tile boundaries; every key but one first seen in the last tile; 32
    distinct keys in every warp; -1, INT_MIN and NaN payloads; each at
    32 and 64 bits."""
    rng = np.random.default_rng(seed)
    cases = []
    for dt in (np.int32, np.int64):
        info = np.iinfo(dt)
        bits = 8 * np.dtype(dt).itemsize
        for n in (tile - 1, tile, tile + 1):
            cases.append((f"n={n} {bits}-bit", rng.integers(-50, 200, n).astype(dt)))
        cases.append((f"one key over 2**20 rows {bits}-bit", np.full(1 << 20, -7, dtype=dt)))
        alt = np.arange(3 * tile + 7) % 2
        runs = np.repeat(np.arange(12) % 2, [31, 33, 1, 1, tile - 1, tile + 1, 32, 32, 5, tile,
                                            2, 3])
        for label, pattern in (("two keys alternating", alt), ("two keys in runs across "
                                                               "warps and tiles", runs)):
            cases.append((f"{label} {bits}-bit", np.where(pattern == 1, info.min, 3).astype(dt)))
        late = np.full(4 * tile + 1000, 11, dtype=dt)
        late[4 * tile :] = rng.permutation(np.arange(1000, 2000)).astype(dt)
        cases.append((f"every key but one first seen in the last tile {bits}-bit", late))
        warps = np.concatenate([rng.permutation(64)[:32] for _ in range(3 * tile // 32 + 2)])
        cases.append((f"32 distinct keys in every warp {bits}-bit", warps.astype(dt)))
        special = np.array([-1, info.min, 0, info.max, 1, -2], dtype=dt)
        cases.append((f"-1, INT_MIN and extremes {bits}-bit", rng.choice(special, 3 * tile + 1)))
    nan64 = np.array([0x7FF8000000000000, 0x7FF8000000000001, 0xFFF8000000000000,
                      0x7FF0000000000001, 0x3FF0000000000000], dtype=np.uint64)
    nan32 = np.array([0x7FC00000, 0x7FC00001, 0xFFC00000, 0x7F800001, 0x3F800000],
                     dtype=np.uint32)
    cases.append(("NaN payloads 64-bit", rng.choice(nan64, 2 * tile + 3).view(np.int64)))
    cases.append(("NaN payloads 32-bit", rng.choice(nan32, 2 * tile + 3).view(np.int32)))
    return cases


# -- compactions at the compaction kernel's edges ---------------------------------


class MaskTakeCase(NamedTuple):
    """One mask_take call: values `flat[shift:]` viewed as rows of
    `row_shape` (a shift off the row width misaligns them), the mask
    `mask[mask_shift:]` (a shift moves its start off 16 bytes) and out_pad."""

    label: str
    flat: np.ndarray
    shift: int
    row_shape: tuple
    mask: np.ndarray
    mask_shift: int
    out_pad: int


def mask_take_args(case: MaskTakeCase, to=np.asarray) -> tuple:
    """(values, mask, out_pad) of a case, each array passed through `to`
    (a host-to-device copy, say) before it is sliced, so a shift gives a
    view whose start is off the allocation's alignment."""
    values = to(case.flat)[case.shift :]
    if case.row_shape:
        values = values.reshape((-1,) + tuple(case.row_shape))
    return values, to(case.mask)[case.mask_shift :], case.out_pad


def mask_take_edge_cases(tile: int, blocks: int, seed: int = 0) -> list:
    """MaskTakeCases at the edges of a compaction that cuts its mask into at
    most `blocks` chunks of whole `tile`-entry tiles, read as 16-byte
    vectors, and places rows of any byte width:
    - tiles: n = tile - 1, tile, tile + 1 and 3 x tile + 5; n = blocks x
      tile + 3 x tile + 7, where a chunk holds two tiles;
    - the mask's start: 1, 3, 8 and 15 bytes past 16-byte alignment, and a
      mask of 5 or 1 entries inside one vector;
    - the mask: all false, all true, one kept entry in the last tile;
    - out_pad: below the count (one tenth, 0), at it, past it (the rest
      hold values[0]) and past n; n = 0;
    - rows: bool, int16, int32 and int64 values; [n, 3], [n, 4] and
      [n, 16] int32 (12-, 16- and 64-byte rows); [n, 2] and [n, 4] int32
      shifted one element (4-byte aligned only); [n, 5] uint8."""
    rng = np.random.default_rng(seed)
    cases = []

    def case(label, n, p=0.5, out_pad=None, dt=np.int32, row_shape=(), shift=0, mask_shift=0,
             mask=None):
        width = int(np.prod(row_shape)) if row_shape else 1
        if dt is np.bool_:
            flat = rng.random(shift + n * width) > 0.5
        else:
            info = np.iinfo(dt)
            flat = rng.integers(info.min, info.max, shift + n * width, dtype=dt, endpoint=True)
        if mask is None:
            mask = rng.random(n) < p
        full = np.concatenate([rng.random(mask_shift) < 0.5, mask])
        cases.append(MaskTakeCase(label, flat, shift, tuple(row_shape), full, mask_shift,
                                  n if out_pad is None else out_pad))

    for n in (tile - 1, tile, tile + 1, 3 * tile + 5):
        case(f"n={n} (tile {tile})", n)
    big = blocks * tile + 3 * tile + 7
    case(f"n={big}: two tiles a chunk", big, p=0.3)
    for s in (1, 3, 8, 15):
        case(f"mask start {s} bytes off 16, int64 values", 2 * tile + 9, dt=np.int64,
             mask_shift=s)
    case("5 entries inside one vector", 5, p=0.6, mask_shift=3)
    case("1 entry at a vector's last byte", 1, p=1.0, mask_shift=15)
    n = 2 * tile + 1
    case("all false", n, p=0.0)
    case("all true", n, p=1.0)
    last = np.zeros(3 * tile, bool)
    last[-2] = True
    case("one kept entry in the last tile", 3 * tile, mask=last)
    case("count past out_pad (a tenth)", n, p=0.9, out_pad=n // 10)
    case("out_pad 0", n, p=0.5, out_pad=0)
    case("out_pad past the count", n, p=0.1, out_pad=n)
    case("out_pad past n", 300, p=0.5, out_pad=400)
    case("n=0", 0, out_pad=4)
    case("n=1 kept", 1, p=1.0, out_pad=3)
    case("n=1 dropped", 1, p=0.0, out_pad=2)
    for dt in (np.bool_, np.int16, np.int64):
        case(f"{np.dtype(dt).name} values", n, dt=dt)
    for shape in ((3,), (4,), (16,)):
        case(f"[n, {shape[0]}] int32 rows", n, row_shape=shape)
    case("[n, 2] int32 rows, 4-byte aligned", n, row_shape=(2,), shift=1)
    case("[n, 4] int32 rows, 4-byte aligned", n, row_shape=(4,), shift=1)
    case("[n, 5] uint8 rows", n, dt=np.uint8, row_shape=(5,))
    return cases


# -- byte-array framings at the framing kernel's edges ----------------------------


class FrameCase(NamedTuple):
    """One plain_bytearray_encode call: data `data[shift:]` (a shift moves
    its start off 16 bytes), offsets into it (they may start past 0) and
    out_len."""

    label: str
    data: np.ndarray
    shift: int
    offsets: np.ndarray
    out_len: int


def frame_args(case: FrameCase, to=np.asarray) -> tuple:
    """(data, offsets, out_len) of a case, the arrays passed through `to`
    before the data is sliced."""
    return to(case.data)[case.shift :], to(case.offsets), case.out_len


def bytearray_frame_edge_cases(tile: int, seed: int = 0) -> list:
    """FrameCases at the edges of a framing whose blocks each write a `tile`
    of output bytes, finding their first value by a search of the frame
    starts:
    - long values: one of 5,000 bytes and one of 70,000 between short ones
      (a value longer than a tile, over many tiles);
    - headers only: 1,024 empty values filling a tile from its first byte,
      and 3,000 empty values in a row;
    - offsets that start past 0 into data 3 bytes off 16-byte alignment;
    - out_len: not a multiple of 16, 37 bytes past the stream (zeros),
      cut 5 bytes inside the stream;
    - n = 1 (a 10-byte value, an empty value, 20 bytes past it); no data
      (50 empty values); no values;
    - frames straddling tile boundaries, and 20,000 values of 12-22 bytes."""
    rng = np.random.default_rng(seed)
    cases = []

    def case(label, lengths, shift=0, lead=0, extra=0):
        lengths = np.asarray(lengths, dtype=np.int64)
        off = np.zeros(len(lengths) + 1, dtype=np.int64)
        np.cumsum(lengths, out=off[1:])
        off += lead
        # bytes past the last value too, unless there is no data at all
        tail = 11 if off[-1] else 0
        data = rng.integers(0, 256, shift + int(off[-1]) + tail, dtype=np.uint8)
        total = 4 * len(lengths) + int(off[-1] - off[0])
        cases.append(FrameCase(label, data, shift, off, total + extra))

    case("a 5,000-byte value", [5000, 0, 3])
    case("a 70,000-byte value between short ones", [3, 70_000, 0, 5])
    # 256 frames of 16 bytes fill the first tile, then 1,024 headers the second
    case("1,024 empty values filling a tile", [12] * (tile // 16) + [0] * (tile // 4) + [7] * 5)
    case("3,000 empty values in a row", [9] * 10 + [0] * 3000 + [4] * 10)
    case("offsets from 37, data 3 bytes off 16", rng.integers(0, 41, 500), shift=3, lead=37)
    ln = rng.integers(0, 41, 777)
    ln[0] += (16 - (4 * len(ln) + int(ln.sum())) % 16) % 16 + 3  # total % 16 == 3
    case("out_len 3 past a multiple of 16", ln)
    case("out_len 37 past the stream", rng.integers(0, 41, 300), extra=37)
    case("out_len cut 5 bytes inside the stream", rng.integers(1, 41, 300), extra=-5)
    case("n=1", [10])
    case("n=1 empty", [0])
    case("n=1, 20 bytes past it", [6], extra=20)
    case("no data: 50 empty values", [0] * 50)
    case("no values, 10 bytes out", [], extra=10)
    case("frames straddling tiles", rng.integers(0, 41, 3 * tile // 20))
    case("20,000 values of 12-22 bytes", rng.integers(12, 23, 20_000))
    return cases


# -- nullable columns at the null expansion's tile edges ---------------------------


class NullableCase(NamedTuple):
    """One expand_nullable call: `values[values_shift:]` and
    `mask[mask_shift:]` (a shift moves a view's start off 16 bytes)."""

    label: str
    values: np.ndarray
    values_shift: int
    mask: np.ndarray
    mask_shift: int


def nullable_args(case: NullableCase, to=np.asarray) -> tuple:
    """(values, mask) of a case, each array passed through `to` (a
    host-to-device copy, say) before it is sliced."""
    return to(case.values)[case.values_shift :], to(case.mask)[case.mask_shift :]


def expand_nullable_edge_cases(tile: int, seed: int = 0, group: int = 0) -> list:
    """NullableCases at the edges of a null expansion that counts tiles of
    `tile` rows (and, past `group` tiles, groups of them), then places each
    tile's rows: n = 0, 1, 15, 16, 17, tile - 1, tile and tile + 1; with
    `group`, group x tile, group x tile + 1 and 2 x group x tile + tile + 3;
    all-valid, all-null and random masks; nv exact, short (the high clamp),
    zero and longer than the count; 1-, 4- and 8-byte values (bool, uint8,
    int32, float32, int64, float64); views of the values and the mask off
    16 bytes."""
    rng = np.random.default_rng(seed)
    cases = []
    dtypes = (np.bool_, np.uint8, np.int32, np.float32, np.int64, np.float64)

    def values(nv, dt):
        if dt is np.bool_:
            return rng.random(nv) < 0.5
        if np.dtype(dt).kind == "f":
            return rng.standard_normal(nv).astype(dt)
        return rng.integers(np.iinfo(dt).min, np.iinfo(dt).max, nv, dtype=dt, endpoint=True)

    def case(label, n, dt, p=0.7, nv_rule="exact", shifts=(0, 0)):
        sv, sm = shifts
        mask = np.zeros(n + sm, dtype=bool)
        mask[sm:] = rng.random(n) < p
        count = int(mask[sm:].sum())
        nv = {"exact": count, "short": max(count - 5, 0), "zero": 0, "long": count + 9}[nv_rule]
        vals = np.zeros(nv + sv, dtype=dt)
        vals[sv:] = values(nv, dt)
        name = np.dtype(dt).name
        cases.append(NullableCase(f"{label}, {name}, n={n}, nv {nv_rule} ({nv})", vals, sv,
                                  mask, sm))

    t = tile
    for k, n in enumerate((0, 1, 15, 16, 17, t - 1, t, t + 1)):
        for dt in dtypes[k % 2 :: 2]:
            case("random mask", n, dt)
    for dt in dtypes:
        case("all valid", 2 * t + 7, dt, p=1.0)
        case("all null", 2 * t + 7, dt, p=0.0)
        case("random mask", 3 * t + 5, dt, nv_rule="short")
        case("random mask", t + 3, dt, nv_rule="zero")
        case("random mask", t + 3, dt, nv_rule="long")
        case("views off 16 bytes", 2 * t + 9, dt, shifts=(1, 3))
        case("mask off 16 bytes", t + 17, dt, shifts=(0, 7))
    case("all valid, high clamp", 2 * t + 7, np.int32, p=1.0, nv_rule="short")
    case("views off 16 bytes, high clamp", t + 33, np.float64, nv_rule="short", shifts=(3, 9))
    if group:
        g = group * t
        case("one whole group of tiles", g, np.int32, p=0.9)
        case("a tile past one group", g + 1, np.float64, p=0.9, nv_rule="short")
        case("past two groups", 2 * g + t + 3, np.uint8, p=0.5, shifts=(5, 1))
    return cases


# -- page grids at the page-grid expansion's tile edges -----------------------------


class GridCase(NamedTuple):
    """One expand_page_grid call: the grid's five (P, W) / (P, R) int32
    arrays (uint32 patterns), a dictionary (int32 or int64), the width and
    n_out."""

    label: str
    grid: tuple
    dictionary: np.ndarray
    width: int
    n_out: int


def _edge_grid(rng, width: int, pages, n_out: int, rle_share: float = 0.3,
               bit_shift=None, index_bits: int = 32):
    """A padded page grid laid out as parallel/mesh.build_page_grid lays one
    out, from each page's run lengths and first start (`pages`: (first,
    lengths) pairs; lengths None is an all-zero padding page): run values
    and payload words random (values up to `index_bits` bits), bit-packed
    runs' payload back to back; `bit_shift` {run: bit_start} overrides
    bit starts (any int32)."""
    runs = [len(ln) for _, ln in pages if ln is not None]
    n_runs = max(runs, default=1)
    n_words = max((sum(int(x) for x in ln) * width + 31) // 32 + 2
                  for _, ln in pages if ln is not None)
    words = np.zeros((len(pages), n_words), np.uint32)
    starts = np.full((len(pages), n_runs), n_out + 1, np.int64)
    is_rle = np.zeros((len(pages), n_runs), np.int32)
    values = np.zeros((len(pages), n_runs), np.uint32)
    bit_starts = np.zeros((len(pages), n_runs), np.int64)
    for p, (first, ln) in enumerate(pages):
        if ln is None:
            starts[p] = 0
            continue
        ln = np.asarray(ln, np.int64)
        r = len(ln)
        starts[p, :r] = first + np.concatenate([[0], np.cumsum(ln[:-1])])
        rle = rng.random(r) < rle_share
        is_rle[p, :r] = rle
        hi = 1 << index_bits
        values[p, :r] = rng.integers(0, hi, r, dtype=np.uint64).astype(np.uint32)
        bits = np.where(rle, 0, ln * width)
        bit_starts[p, :r] = np.concatenate([[0], np.cumsum(bits[:-1])])
        words[p] = rng.integers(0, 1 << 32, n_words, dtype=np.uint64).astype(np.uint32)
    for (p, r), b in (bit_shift or {}).items():
        bit_starts[p, r] = b
    grid = (words.view(np.int32), starts.astype(np.int32), is_rle, values.view(np.int32),
            bit_starts.astype(np.int64).astype(np.int32))
    return tuple(np.ascontiguousarray(a) for a in grid)


def page_grid_edge_cases(tile: int, items: int, stage_runs: int, seed: int = 0) -> list:
    """GridCases at the edges of a page-grid expansion whose blocks take
    `tile` consecutive outputs of a page, a thread `items` of them, and
    stage at most `stage_runs` runs of a tile in shared memory: at widths 0,
    1, 3, 12, 17 and 32, n_out off a multiple of the tile; runs shorter
    than a thread's outputs (staged whole, and past the stage); more runs
    in a tile than the stage holds, and a long table whose tiles each span
    fewer; a page whose real count ends inside a tile (its last run read
    into the padding, words past the end clamped) and an all-zero padding
    page; bit starts near 2^31 (bitpos wraps) and negative ones (w0 below
    0, wrapped once, then clamped); a first start above 0 (the run clipped
    to 0) and an is_rle of 2 (not RLE); int32 and int64 dictionaries
    shorter than the index range."""
    rng = np.random.default_rng(seed)
    cases = []
    t = tile

    def lengths(total, lo, hi):
        ln = []
        while sum(ln) < total:
            ln.append(int(rng.integers(lo, hi + 1)))
        ln[-1] -= sum(ln) - total
        return [x for x in ln if x > 0]

    for k, width in enumerate((0, 1, 3, 12, 17, 32)):
        d_len = max(2, (1 << min(width, 20)) // 3)
        dt = (np.int64, np.int32)[k % 2]

        def case(label, pages, n_out, **kw):
            grid = _edge_grid(rng, width, pages, n_out, **kw)
            lo, hi = (-(2**62), 2**62) if dt is np.int64 else (-(2**31), 2**31 - 1)
            d = rng.integers(lo, hi, d_len, dtype=np.int64).astype(dt)
            cases.append(GridCase(f"width {width}: {label}", grid, d, width, n_out))

        n = 2 * t + 37
        case(f"n_out {n} (off the tile), a page ending inside a tile, a padding page",
             [(0, lengths(n, 100, 900)), (0, lengths(n - 500, 60, 700)), (0, None)], n)
        case(f"runs of 1 to {items - 1} outputs, staged whole",
             [(0, lengths(200, 1, items - 1)), (0, lengths(190, 2, items - 1))], 200,
             rle_share=0.5)
        case(f"runs of 1 to {items - 1} outputs, more than {stage_runs} a tile",
             [(0, lengths(n, 1, items - 1)), (0, lengths(n, 2, 5))], n, rle_share=0.5)
        case(f"runs of 20 to 40 outputs, more than {stage_runs} a table, fewer a tile",
             [(0, lengths(3 * t, 20, 40)), (0, lengths(3 * t - 11, 20, 40))], 3 * t)
        n = t + 5
        case("bit starts near 2^31 (bitpos wraps) and negative (w0 below 0)",
             [(0, lengths(n, 150, 400)), (0, lengths(n, 150, 400))], n, rle_share=0.0,
             bit_shift={(0, 1): 2**31 - 3 * width - 40, (0, 2): -70, (1, 0): -(2**31) + 7,
                        (1, 1): 2**31 - 1})
        grid = _edge_grid(rng, width, [(37, lengths(600, 50, 200))], 700)
        grid[2][0, 1] = 2  # not RLE: the JAX program tests is_rle == 1
        lo, hi = (-(2**62), 2**62) if dt is np.int64 else (-(2**31), 2**31 - 1)
        cases.append(GridCase(f"width {width}: first start 37 (run clipped to 0), is_rle 2",
                              grid, rng.integers(lo, hi, d_len, dtype=np.int64).astype(dt),
                              width, 700))
    return cases
