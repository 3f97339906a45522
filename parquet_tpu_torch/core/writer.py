"""FileWriter: the low-level write API, columnar and serial.

A copy of parquet_tpu/core/writer.py, cut to what the device write path
needs (reference: file_writer.go:15-27, :46-77 ctor/options, :229-276
FlushRowGroup, :297-350 Close/footer):

  write_column(path, values, def_levels=, rep_levels=)   host values
  write_device_column(path, tensor | (data, offsets))    device values
  flush_row_group(), close(), abort(), `with FileWriter(...) as w:`

Per row group each leaf's values become a typed array, the dictionary
decision is made over the whole chunk, pages of <= max_page_size are
emitted ([dict page] + data pages, V1 or V2), and close() writes the Thrift
footer. Bytes leave through a ByteSink (sink/sink.py): a path is written to
a temp file renamed over the destination at close, so a fault or an abort
never leaves a torn file. A device column is encoded by
kernels/pipeline.encode_device_column, byte-identical to write_column of the
same values; the shapes it declines are encoded on the host, counted
(write_counts()).

Left out, each raising WriterError that names its slice: the row path
(write_row / write_rows over the Shredder, with the host row assembly),
`parallel=` (the encode pipeline), `write_page_index=` and `bloom_filters=`
(the page index and bloom writes).
"""

from __future__ import annotations

import numpy as np
import torch

from ..meta.file_meta import MAGIC, serialize_footer
from ..meta.parquet_types import (
    ColumnOrder,
    CompressionCodec,
    Encoding,
    FileMetaData,
    KeyValue,
    RowGroup,
    SortingColumn,
    Type,
    TypeDefinedOrder,
)
from ..sink.encoder import EncoderConfig, assemble_group, commit_group, encode_chunk
from ..sink.sink import open_sink
from .column_store import MAX_PAGE_SIZE_DEFAULT, ColumnChunkBuilder
from .schema import Column, Schema

__all__ = ["FileWriter", "WriterError", "write_counts", "reset_write_counts"]

ROW_GROUP_SIZE_DEFAULT = 128 << 20  # bytes, reference file_writer.go default

# Allowed fallback (non-dictionary) encodings per physical type — the write
# side of the reference's encoder selection matrix (chunk_writer.go:13-128).
_ALLOWED_ENCODINGS = {
    Type.BOOLEAN: {Encoding.PLAIN, Encoding.RLE},
    Type.INT32: {
        Encoding.PLAIN,
        Encoding.DELTA_BINARY_PACKED,
        Encoding.BYTE_STREAM_SPLIT,
    },
    Type.INT64: {
        Encoding.PLAIN,
        Encoding.DELTA_BINARY_PACKED,
        Encoding.BYTE_STREAM_SPLIT,
    },
    Type.INT96: {Encoding.PLAIN},
    Type.FLOAT: {Encoding.PLAIN, Encoding.BYTE_STREAM_SPLIT},
    Type.DOUBLE: {Encoding.PLAIN, Encoding.BYTE_STREAM_SPLIT},
    Type.BYTE_ARRAY: {
        Encoding.PLAIN,
        Encoding.DELTA_LENGTH_BYTE_ARRAY,
        Encoding.DELTA_BYTE_ARRAY,
    },
    Type.FIXED_LEN_BYTE_ARRAY: {Encoding.PLAIN, Encoding.BYTE_STREAM_SPLIT},
}

# Device write routing, as plain counters: a device column encoded on the
# device (engaged) or, for a shape the device encoder declines, on the host.
_COUNTS = {"device_write_engaged": 0, "device_write_declined": 0}


def write_counts() -> dict:
    """The device write counters: device_write_engaged and
    device_write_declined."""
    return dict(_COUNTS)


def reset_write_counts() -> None:
    for k in _COUNTS:
        _COUNTS[k] = 0


class WriterError(ValueError):
    pass


class FileWriter:
    """Writes Parquet files from host arrays and device tensors.

    Usage:
        w = FileWriter(path, schema, codec="snappy")
        w.write_column("a", np.arange(100))              # host values
        w.write_device_column("b", torch.arange(100, device="cuda"))
        w.flush_row_group()
        w.close()

    `sink` is a path (written ATOMICALLY: a temp file renamed over the
    destination at close, so failures never leave a torn file), a writable
    binary file object, or any ByteSink.
    """

    def __init__(
        self,
        sink,
        schema: Schema,
        *,
        codec: CompressionCodec | str = CompressionCodec.UNCOMPRESSED,
        created_by: str = "parquet_tpu",
        data_page_version: int = 1,
        max_page_size: int = MAX_PAGE_SIZE_DEFAULT,
        row_group_size: int = ROW_GROUP_SIZE_DEFAULT,
        enable_dictionary: bool = True,
        column_encodings: dict | None = None,
        use_dictionary=None,
        with_crc: bool = False,
        key_value_metadata: dict | None = None,
        write_page_index: bool = False,
        bloom_filters=None,
        sorting_columns=None,
        parallel=False,
    ):
        """`column_encodings` maps a leaf ("a.b" or tuple) to the fallback
        value encoding used when the column is not dictionary-encoded:
        PLAIN (default), DELTA_BINARY_PACKED (int32/int64), RLE (boolean),
        DELTA_LENGTH_BYTE_ARRAY / DELTA_BYTE_ARRAY (byte arrays).
        `use_dictionary` is True/False for all columns or a list of leaves
        to dictionary-encode (overrides `enable_dictionary` when given).
        `sorting_columns` declares the row ordering in row-group metadata
        (not enforced): leaf names or (leaf, descending, nulls_first)
        triples. `write_page_index`, `bloom_filters` and `parallel` are not
        ported yet and raise."""
        # Validate EVERY option before the sink opens: a typo'd codec or
        # column name must fail before any filesystem effect.
        for name, value, slice_ in (
            ("write_page_index", write_page_index, "the page index"),
            ("bloom_filters", bloom_filters, "bloom filter writes"),
            ("parallel", parallel, "the parallel encode pipeline"),
        ):
            if value:
                raise WriterError(f"writer: {name}= comes with {slice_}, not ported yet")
        self.schema = schema
        if isinstance(codec, str):
            try:
                codec = CompressionCodec[codec.upper()]
            except KeyError:
                valid = ", ".join(c.name.lower() for c in CompressionCodec)
                raise WriterError(
                    f"writer: unknown codec {codec!r} (expected one of: {valid})"
                ) from None
        self.codec = codec
        if data_page_version not in (1, 2):
            raise WriterError("writer: data page version must be 1 or 2")
        self.data_page_version = data_page_version
        self.max_page_size = max_page_size
        self.row_group_size = row_group_size
        self.enable_dictionary = enable_dictionary
        self._column_encodings = self._resolve_encodings(schema, column_encodings)
        self._dict_columns = self._resolve_use_dictionary(
            schema, use_dictionary, enable_dictionary
        )
        self.with_crc = with_crc
        self.created_by = created_by
        self.key_value_metadata = dict(key_value_metadata or {})
        self._sorting = self._resolve_sorting(schema, sorting_columns)
        self._row_groups: list[RowGroup] = []
        self._cfg = EncoderConfig(
            codec=int(self.codec),
            data_page_version=data_page_version,
            max_page_size=max_page_size,
            with_crc=with_crc,
            column_encodings=dict(self._column_encodings),
            sorting=tuple(self._sorting) if self._sorting else None,
        )
        self._pos = 0
        self._closed = False
        self._aborted = False
        self._failed: BaseException | None = None
        self._meta: FileMetaData | None = None
        self._reset_builders()
        self._sink, self._owns_sink = open_sink(sink)
        try:
            self._write(MAGIC)  # leading magic (reference: file_writer.go:240-244)
        except OSError as e:
            self.abort()
            raise WriterError(f"writer: sink write failed: {e}") from e

    @staticmethod
    def _leaf(schema: Schema, key) -> Column:
        try:
            leaf = schema.column(key)
        except Exception:
            raise WriterError(
                f"writer: {key!r} is not a leaf column of the schema"
            ) from None
        if not leaf.is_leaf:
            raise WriterError(f"writer: {key!r} is not a leaf column of the schema")
        return leaf

    def _resolve_encodings(self, schema: Schema, column_encodings) -> dict:
        out: dict[tuple, Encoding] = {}
        for key, enc in (column_encodings or {}).items():
            leaf = self._leaf(schema, key)
            if isinstance(enc, str):
                try:
                    enc = Encoding[enc.upper()]
                except KeyError:
                    raise WriterError(f"writer: unknown encoding {enc!r}") from None
            enc = Encoding(enc)
            allowed = _ALLOWED_ENCODINGS.get(leaf.type, {Encoding.PLAIN})
            if enc not in allowed:
                names = ", ".join(sorted(e.name for e in allowed))
                raise WriterError(
                    f"writer: encoding {enc.name} not supported for "
                    f"{leaf.type.name} column {key!r} (allowed: {names})"
                )
            out[leaf.path] = enc
        return out

    def _resolve_use_dictionary(self, schema: Schema, use_dictionary, default) -> set:
        if use_dictionary is None:
            use_dictionary = default
        if use_dictionary is True:
            return {leaf.path for leaf in schema.leaves}
        if use_dictionary is False:
            return set()
        if isinstance(use_dictionary, str):
            use_dictionary = [use_dictionary]  # one column, not its characters
        return {self._leaf(schema, k).path for k in use_dictionary}

    def _resolve_sorting(self, schema: Schema, sorting_columns):
        if not sorting_columns:
            return None
        if isinstance(sorting_columns, str):
            sorting_columns = [sorting_columns]
        out = []
        for spec in sorting_columns:
            if isinstance(spec, str):
                key, descending, nulls_first = spec, False, False
            elif (
                isinstance(spec, (tuple, list))
                and len(spec) == 3
                and isinstance(spec[1], (bool, int))
            ):
                key, descending, nulls_first = spec
            else:
                raise WriterError(
                    "writer: sorting_columns entries are dotted leaf names "
                    "or (name, descending, nulls_first) triples"
                )
            leaf = self._leaf(schema, key)
            out.append(
                SortingColumn(
                    column_idx=leaf.leaf_index,
                    descending=bool(descending),
                    nulls_first=bool(nulls_first),
                )
            )
        return out

    def _reset_builders(self) -> None:
        self._builders = {
            leaf.path: ColumnChunkBuilder(leaf, leaf.path in self._dict_columns)
            for leaf in self.schema.leaves
        }
        self._device_columns: dict[tuple, object] = {}
        self._columnar_rows = None

    def _write(self, data: bytes) -> int:
        off = self._pos
        self._sink.write(data)
        self._pos += len(data)
        return off

    # -- ingestion -------------------------------------------------------------

    def write_row(self, row: dict) -> None:
        raise WriterError(
            "writer: write_row comes with the Shredder and the host row assembly, "
            "not ported yet (use write_column)"
        )

    def write_rows(self, rows) -> None:
        raise WriterError(
            "writer: write_rows comes with the Shredder and the host row assembly, "
            "not ported yet (use write_column)"
        )

    def _set_rows(self, leaf: Column, n_rows: int) -> None:
        if self._columnar_rows is None:
            self._columnar_rows = n_rows
        elif self._columnar_rows != n_rows:
            raise WriterError(
                f"writer: column {leaf.path_str} has {n_rows} rows, "
                f"others have {self._columnar_rows}"
            )

    def _columnar_leaf(self, path) -> Column:
        leaf = self.schema.column(path)
        if not leaf.is_leaf:
            raise WriterError(f"writer: {leaf.path_str} is not a leaf column")
        return leaf

    def write_column(self, path, values, def_levels=None, rep_levels=None) -> None:
        """Columnar path for one leaf of the current row group.

        For flat REQUIRED columns pass just `values`; for OPTIONAL pass
        def_levels (values holds the non-null cells); for nested columns
        pass explicit def/rep levels (Dremel encoding).
        """
        self._check_open()
        leaf = self._columnar_leaf(path)
        self._builders[leaf.path].set_columnar(values, def_levels, rep_levels)
        n_rows = (
            int((np.asarray(rep_levels) == 0).sum())
            if rep_levels is not None and len(rep_levels)
            else (len(def_levels) if def_levels is not None else len(values))
        )
        self._set_rows(leaf, n_rows)

    def write_device_column(self, path, values) -> None:
        """Columnar path for a DEVICE-RESIDENT leaf: tensors go to pages with
        no host round trip of the raw values (kernels/pipeline.
        encode_device_column runs the dictionary probe, hybrid/bit-pack,
        DELTA block scans and byte-array framing on the device; the host
        frames pages and compresses). Output bytes are IDENTICAL to
        write_column for the same values.

        `values` is a 1-D tensor for numeric leaves, or a `(data, offsets)`
        pair of tensors for BYTE_ARRAY leaves. The leaf must be flat
        REQUIRED. Shapes the device encoder does not take (BYTE_STREAM_SPLIT,
        booleans, a dictionary-eligible BYTE_ARRAY, a tensor whose dtype
        does not match the leaf, ...) are encoded on the host at flush time,
        counted (`device_write_engaged` / `device_write_declined` in
        write_counts()). The tensors are read at flush: they must stay
        unchanged until then."""
        self._check_open()
        leaf = self._columnar_leaf(path)
        if leaf.max_rep > 0 or leaf.max_def > 0:
            raise WriterError(
                f"writer: {leaf.path_str} is not flat REQUIRED — device "
                "columns carry no levels (use write_column)"
            )
        if leaf.type == Type.BYTE_ARRAY:
            try:
                data, offsets = values
            except (TypeError, ValueError):
                raise WriterError(
                    "writer: BYTE_ARRAY device columns take a (data, offsets) pair"
                ) from None
            tensors = (data, offsets)
            n_rows = len(offsets) - 1
        else:
            tensors = (values,)
            n_rows = len(values)
        if not all(isinstance(t, torch.Tensor) for t in tensors):
            raise WriterError(
                f"writer: write_device_column takes torch tensors for {leaf.path_str} "
                "(use write_column for host arrays)"
            )
        self._set_rows(leaf, n_rows)
        self._device_columns[leaf.path] = values

    def _encode_device_chunk(self, leaf: Column, values, kv):
        """Encode one device-buffered leaf at flush time: the device route,
        or the counted host encode for a shape it declines."""
        from ..kernels.pipeline import EncodeDeclined, encode_device_column

        use_dict = leaf.path in self._dict_columns
        try:
            ec = encode_device_column(leaf, values, self._cfg, kv, enable_dict=use_dict)
        except EncodeDeclined:
            _COUNTS["device_write_declined"] += 1
            return self._host_encode_device_values(leaf, values, kv, use_dict)
        _COUNTS["device_write_engaged"] += 1
        return ec

    def _host_encode_device_values(self, leaf, values, kv, use_dict):
        if leaf.type == Type.BYTE_ARRAY:
            from ..kernels.pipeline import host_byte_array

            host = host_byte_array(*values)
        else:
            host = values.cpu().numpy()
        b = ColumnChunkBuilder(leaf, use_dict)
        b.set_columnar(host)
        return encode_chunk(self._cfg, b, kv)

    # -- row group flush -------------------------------------------------------

    def flush_row_group(self, metadata=None, column_metadata=None) -> None:
        """Flush the buffered columns as one row group.

        `metadata` ({k: v}) attaches key-value metadata to every column chunk
        of this row group; `column_metadata` ({leaf: {k: v}}) targets single
        columns (reference: file_writer.go:156-226)."""
        self._check_open()
        per_col: dict[tuple, dict] = {}
        if metadata or column_metadata:
            if self._columnar_rows is None:
                raise WriterError(
                    "writer: flush_row_group with metadata but nothing buffered"
                )
            for leaf in self.schema.leaves:
                per_col[leaf.path] = dict(metadata or {})
            for key, kv in (column_metadata or {}).items():
                per_col.setdefault(self._leaf(self.schema, key).path, {}).update(kv)
        if self._columnar_rows is None:
            return  # nothing buffered
        n_rows = self._columnar_rows
        missing = [
            leaf.path_str
            for leaf in self.schema.leaves
            if self._builders[leaf.path]._columnar_values is None
            and leaf.path not in self._device_columns
        ]
        if missing:
            raise WriterError(f"writer: columnar row group missing columns {missing}")
        # snapshot the builders (leaf order) and hand the writer fresh ones
        leaves = self.schema.leaves
        builders = [self._builders[leaf.path] for leaf in leaves]
        kvs = [per_col.get(leaf.path) for leaf in leaves]
        device_cols = self._device_columns
        self._reset_builders()
        try:
            chunks = [
                self._encode_device_chunk(leaf, device_cols[leaf.path], kv)
                if leaf.path in device_cols
                else encode_chunk(self._cfg, b, kv)
                for leaf, b, kv in zip(leaves, builders, kvs)
            ]
            erg = assemble_group(self._cfg, chunks, n_rows)
        except Exception as e:
            # the group's builders are already consumed: continuing would
            # let close() commit a valid-LOOKING file with this row group
            # silently missing — poison the writer and tear the output down
            self._failed = e
            self.abort()
            raise
        erg.row_group.ordinal = len(self._row_groups)
        try:
            self._pos = commit_group(erg, self._sink, self._pos)
        except Exception as e:
            # the sink rejected bytes mid-group: _pos is out of sync with the
            # sink, so the writer can never produce a coherent file
            self._failed = e
            self.abort()
            raise WriterError(f"writer: flush failed: {e}") from e
        self._row_groups.append(erg.row_group)

    # -- lifecycle -------------------------------------------------------------

    def close(self) -> FileMetaData | None:
        """Flush, write the footer and COMMIT the sink (atomic rename for
        path sinks). Idempotent: a second close returns the same
        FileMetaData. After a write fault (or abort) close() aborts instead
        and returns None."""
        if self._closed:
            return self._meta
        if self._aborted:
            return None
        if self._failed is not None:
            # the failure was already raised to the caller: quiet abort
            self.abort()
            return None
        try:
            self.flush_row_group()
            try:
                meta = self._write_tail()
                self._sink.flush()
                if self._owns_sink:
                    self._sink.close()  # atomic commit for path sinks
            except OSError as e:
                self._failed = e
                raise WriterError(f"writer: close failed: {e}") from e
        except BaseException:
            self.abort()
            raise
        self._closed = True
        self._meta = meta
        return meta

    def _write_tail(self) -> FileMetaData:
        meta = FileMetaData(
            version=2,
            schema=self.schema.to_thrift(),
            num_rows=sum(rg.num_rows or 0 for rg in self._row_groups),
            row_groups=self._row_groups,
            created_by=self.created_by,
            key_value_metadata=[
                KeyValue(key=k, value=v) for k, v in self.key_value_metadata.items()
            ]
            or None,
            column_orders=[
                ColumnOrder(TYPE_ORDER=TypeDefinedOrder())
                for _ in self.schema.leaves
            ],
        )
        self._write(serialize_footer(meta))
        return meta

    def abort(self) -> None:
        """Abandon the file: discard the sink WITHOUT committing (the atomic
        path sink deletes its temp file; the destination is untouched).
        Idempotent, and a no-op after a successful close()."""
        if self._closed or self._aborted:
            return
        self._aborted = True
        try:
            self._sink.abort()
        except Exception:
            pass  # abort is the error path: best-effort cleanup only

    def _check_open(self) -> None:
        if self._failed is not None:
            raise WriterError(
                "writer: an earlier write failed; the writer is unusable "
                "(the output was not committed)"
            ) from self._failed
        if self._closed or self._aborted:
            raise WriterError("writer: already closed")

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *rest):
        if exc_type is None:
            self.close()
        else:
            # an exception inside the `with` must NOT commit a half-written
            # file: tear down the temp file instead
            self.abort()
        return False
