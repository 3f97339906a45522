"""FileWriter: the low-level write API, by rows or by columns.

A copy of parquet_tpu/core/writer.py (reference: file_writer.go:15-27,
:46-77 ctor/options, :229-276 FlushRowGroup, :280-290 auto-flush, :297-350
Close/footer):

  write_row(row) / write_rows(rows)                      host rows
  write_column(path, values, def_levels=, rep_levels=)   host values
  write_device_column(path, tensor | (data, offsets))    device values
  flush_row_group(), close(), abort(), `with FileWriter(...) as w:`

Per row group each leaf's values become a typed array, the dictionary
decision is made over the whole chunk, pages of <= max_page_size are
emitted ([dict page] + data pages, V1 or V2; sink/encoder.py's fused native
walk or its staged Python loop), and close() writes the bloom filters
(`bloom_filters=`), then every ColumnIndex and every OffsetIndex
(`write_page_index=`), then the Thrift footer. Bytes leave through a
ByteSink (sink/sink.py): a path is written to a temp file renamed over the
destination at close, so a fault or an abort never leaves a torn file.
`parallel=` fans chunk encodes out on the pqt-encode pool while one
in-order flusher commits groups, byte-identical to the serial write, with
bounded in-flight bytes (`max_inflight_bytes=`) and faults raised as
WriterError on the writer's next call. A device column is encoded by
kernels/pipeline.encode_device_column, byte-identical to write_column of the
same values; the shapes it declines are encoded on the host, counted
(write_counts()).

Rows (dicts, nested as the schema nests: LIST groups take Python lists,
MAP groups dicts, and the raw wire shape is accepted too) are shredded into
per-leaf (value, def, rep) streams by core/shred.Shredder on the host;
flat schemas take a batched columnar shred in write_rows, staged and then
committed, so a bad row leaves the writer consistent (a bad nested row,
shredded field by field, leaves its earlier fields' entries behind, as in
the reference). At flush the streams
become ColumnChunkBuilder input and go through the same chunk encode as
write_column (the fused native walk or the staged loop, dictionaries,
blooms, the page index, `parallel=`), so a row-written file is
byte-identical to the JAX package's. A row group flushes itself once its
estimated size reaches `row_group_size`. Rows and columns cannot mix in one
row group.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

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
from ..sink.encoder import (
    EncodePipeline,
    EncoderConfig,
    assemble_group,
    commit_group,
    encode_chunk,
    encode_pool,
)
from ..sink.counts import count, reset_write_counts, write_counts
from ..sink.sink import open_sink
from ..utils import metrics as _metrics
from .column_store import MAX_PAGE_SIZE_DEFAULT, ColumnChunkBuilder
from .schema import Column, Schema
from .shred import ShredError, Shredder, _value_size

__all__ = ["FileWriter", "WriterError", "write_counts", "reset_write_counts"]

ROW_GROUP_SIZE_DEFAULT = 128 << 20  # bytes, reference file_writer.go default

# parallel=: the most estimated input bytes buffered between encode and
# flush, the backpressure that keeps a fast producer from buffering every
# pending row group in memory while the sink drains.
MAX_INFLIGHT_BYTES_DEFAULT = 256 << 20

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

_MIX = "writer: cannot mix write_row and write_column in one row group"


class WriterError(ValueError):
    pass


class FileWriter:
    """Writes Parquet files from host rows, host arrays and device tensors.

    Usage:
        w = FileWriter(path, schema, codec="snappy")
        w.write_row({"a": 1, "s": "x"})                  # row path
        w.write_column("a", np.arange(100))              # host values
        w.write_device_column("b", torch.arange(100, device="cuda"))
        w.flush_row_group()
        w.close()

    `sink` is a path (written ATOMICALLY: a temp file renamed over the
    destination at close, so failures never leave a torn file), a writable
    binary file object, or any ByteSink. `parallel=True` encodes row
    groups on the shared pqt-encode pool (an int spins up a dedicated pool
    of that many workers); output bytes are identical to the serial path.
    Encode/flush faults in parallel mode surface as WriterError on the next
    writer call (deferred propagation) and the destination is never
    committed.
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
        max_inflight_bytes: int = MAX_INFLIGHT_BYTES_DEFAULT,
    ):
        """`column_encodings` maps a leaf ("a.b" or tuple) to the fallback
        value encoding used when the column is not dictionary-encoded:
        PLAIN (default), DELTA_BINARY_PACKED (int32/int64), RLE (boolean),
        DELTA_LENGTH_BYTE_ARRAY / DELTA_BYTE_ARRAY (byte arrays).
        `use_dictionary` is True/False for all columns or a list of leaves
        to dictionary-encode (overrides `enable_dictionary` when given).
        `write_page_index=True` emits the Parquet page index (ColumnIndex +
        OffsetIndex per chunk, written between the last row group and the
        footer): per-page min/max/null stats readers use for page pruning.
        `bloom_filters` emits split-block bloom filters: a {leaf: True |
        {"fpp": float, "ndv": int}} dict, a list of leaves, or True for every
        eligible leaf; default fpp 0.01, default ndv the chunk's value count
        (exact for dictionary chunks).
        `sorting_columns` declares the row ordering in row-group metadata
        (not enforced): leaf names or (leaf, descending, nulls_first)
        triples.
        `parallel` enables the pqt-encode pipeline (True = shared pool,
        int = dedicated pool of that size); `max_inflight_bytes` bounds the
        estimated encoded bytes buffered between encode and flush."""
        # Validate EVERY option before the sink opens: a typo'd codec or
        # column name must fail before any filesystem effect.
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
        self._shredder = Shredder(schema)
        self._row_groups: list[RowGroup] = []
        self.write_page_index = write_page_index
        # aligned with _row_groups: per group, per chunk (leaf order):
        # (ColumnChunk, ColumnIndex, OffsetIndex) awaiting emission at close
        self._page_indexes: list[list] = []
        self._bloom_specs = self._resolve_blooms(schema, bloom_filters)
        self._sorting = self._resolve_sorting(schema, sorting_columns)
        self._blooms: list[tuple] = []  # (ColumnMetaData, BloomFilter)
        self._cfg = EncoderConfig(
            codec=int(self.codec),
            data_page_version=data_page_version,
            max_page_size=max_page_size,
            with_crc=with_crc,
            column_encodings=dict(self._column_encodings),
            sorting=tuple(self._sorting) if self._sorting else None,
            write_page_index=write_page_index,
            bloom_specs=dict(self._bloom_specs),
        )
        self._own_pool: ThreadPoolExecutor | None = None
        pool = None
        if parallel:
            if parallel is True:
                pool = encode_pool()
            else:
                workers = int(parallel)
                if workers < 1:
                    raise WriterError(
                        "writer: parallel must be True or a positive worker count"
                    )
                self._own_pool = ThreadPoolExecutor(
                    max_workers=workers, thread_name_prefix="pqt-encode"
                )
                pool = self._own_pool
        self._pos = 0
        self._closed = False
        self._aborted = False
        self._failed: BaseException | None = None
        self._meta: FileMetaData | None = None
        self._reset_builders()
        self._sink, self._owns_sink = open_sink(sink)
        self._pipeline: EncodePipeline | None = None
        try:
            self._write(MAGIC)  # leading magic (reference: file_writer.go:240-244)
        except OSError as e:
            self.abort()
            raise WriterError(f"writer: sink write failed: {e}") from e
        if pool is not None:
            self._pipeline = EncodePipeline(
                self._cfg,
                self._sink,
                self._pos,
                pool=pool,
                max_inflight_bytes=max_inflight_bytes,
            )

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

    _BLOOM_TYPES = (
        Type.INT32,
        Type.INT64,
        Type.FLOAT,
        Type.DOUBLE,
        Type.BYTE_ARRAY,
        Type.FIXED_LEN_BYTE_ARRAY,
    )

    def _resolve_blooms(self, schema: Schema, bloom_filters) -> dict:
        """{leaf path: (ndv or None, fpp)} for leaves that get a bloom filter."""
        if not bloom_filters:
            return {}
        if bloom_filters is True:
            bloom_filters = {
                leaf.path: True
                for leaf in schema.leaves
                if leaf.type in self._BLOOM_TYPES
            }
        elif isinstance(bloom_filters, str):
            bloom_filters = {bloom_filters: True}  # one column, not its chars
        elif not isinstance(bloom_filters, dict):
            bloom_filters = {k: True for k in bloom_filters}
        out = {}
        for key, spec in bloom_filters.items():
            leaf = self._leaf(schema, key)
            if leaf.type not in self._BLOOM_TYPES:
                raise WriterError(
                    f"writer: bloom filter unsupported for {leaf.type.name} "
                    f"column {leaf.path_str}"
                )
            if spec is True:
                out[leaf.path] = (None, 0.01)
            else:
                out[leaf.path] = (spec.get("ndv"), spec.get("fpp", 0.01))
        return out

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
        self._check_open()
        if self._columnar_rows is not None:
            raise WriterError(_MIX)
        self._shredder.add_row(row)
        if self._shredder.num_rows % 1000 == 0 and self._estimated_size() >= self.row_group_size:
            self.flush_row_group()

    def write_rows(self, rows) -> None:
        """Bulk ingestion; flat schemas take a batched columnar shred that
        skips the per-row recursive walk (one pass per column per batch)."""
        root = self.schema.root
        if any(not c.is_leaf or c.max_rep > 0 or c.max_def > 1 for c in root.children):
            for row in rows:
                self.write_row(row)
            return
        self._check_open()
        if self._columnar_rows is not None:
            raise WriterError(_MIX)
        batch: list = []
        for row in rows:
            batch.append(row)
            if len(batch) >= 4096:
                self._write_flat_batch(batch)
                batch.clear()
        if batch:
            self._write_flat_batch(batch)

    def _write_flat_batch(self, batch: list) -> None:
        # Phase 1 — validate + stage every column WITHOUT touching buffers,
        # so a bad row leaves the writer consistent (a partial append would
        # silently misalign columns and close() would write a corrupt file).
        for row in batch:
            if not isinstance(row, dict):
                raise ShredError(f"shred: row must be a dict, got {type(row).__name__}")
        staged = []
        for leaf in self.schema.root.children:
            name = leaf.name
            vals = []
            if leaf.max_def == 1:
                defs = []
                for row in batch:
                    v = row.get(name)
                    if v is None:
                        defs.append(0)
                    else:
                        defs.append(1)
                        vals.append(v)
            else:
                for row in batch:
                    v = row.get(name)
                    if v is None:
                        raise ShredError(f"shred: required field {leaf.path_str} is None")
                    vals.append(v)
                defs = [0] * len(batch)
            staged.append((self._shredder.buffers[leaf.path], vals, defs))
        # Phase 2 — commit (list extends cannot fail on valid staged data)
        for buf, vals, defs in staged:
            buf.values.extend(vals)
            buf.def_levels.extend(defs)
            buf.rep_levels.extend([0] * len(batch))
            buf.data_size += sum(_value_size(v) for v in vals)
        self._shredder.num_rows += len(batch)
        if self._estimated_size() >= self.row_group_size:
            self.flush_row_group()

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
        if self._shredder.num_rows:
            raise WriterError(_MIX)
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
        unchanged until then. Incompatible with `parallel=`: the encode
        pipeline snapshots host builders."""
        self._check_open()
        if self._shredder.num_rows:
            raise WriterError(_MIX)
        if self._pipeline is not None:
            raise WriterError(
                "writer: write_device_column requires a serial writer "
                "(parallel=False)"
            )
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
            count("device_write_declined")
            return self._host_encode_device_values(leaf, values, kv, use_dict)
        count("device_write_engaged")
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

    def _estimated_size(self) -> int:
        total = 0
        for b in self._shredder.buffers.values():
            total += b.data_size + 2 * len(b.def_levels)
        return total

    def estimated_buffered_size(self) -> int:
        """Approximate bytes of the not-yet-flushed rows (the sizing input of
        the auto-flush; public for tools sizing output parts)."""
        return self._estimated_size()

    # -- row group flush -------------------------------------------------------

    def flush_row_group(self, metadata=None, column_metadata=None) -> None:
        """Flush the buffered rows or columns as one row group.

        `metadata` ({k: v}) attaches key-value metadata to every column chunk
        of this row group; `column_metadata` ({leaf: {k: v}}) targets single
        columns (reference: file_writer.go:156-226).

        With `parallel=`, the encode runs in the background: this returns as
        soon as the group's builders are snapshotted and fanned out (or
        blocks briefly on the in-flight-bytes backpressure), and any fault
        surfaces as WriterError on a LATER call (deferred propagation)."""
        self._check_open()
        per_col: dict[tuple, dict] = {}
        if metadata or column_metadata:
            if not self._shredder.num_rows and self._columnar_rows is None:
                raise WriterError(
                    "writer: flush_row_group with metadata but nothing buffered "
                    "(an auto-flush may have emptied the buffer)"
                )
            for leaf in self.schema.leaves:
                per_col[leaf.path] = dict(metadata or {})
            for key, kv in (column_metadata or {}).items():
                per_col.setdefault(self._leaf(self.schema, key).path, {}).update(kv)
        if self._shredder.num_rows:
            shredded, n_rows = self._shredder.drain()
            for path, (vals, dls, rls) in shredded.items():
                self._builders[path].extend_shredded(vals, dls, rls)
        elif self._columnar_rows is not None:
            n_rows = self._columnar_rows
            missing = [
                leaf.path_str
                for leaf in self.schema.leaves
                if self._builders[leaf.path]._columnar_values is None
                and leaf.path not in self._device_columns
            ]
            if missing:
                raise WriterError(f"writer: columnar row group missing columns {missing}")
        else:
            return  # nothing buffered
        # snapshot the builders (leaf order) and hand the writer fresh ones
        leaves = self.schema.leaves
        builders = [self._builders[leaf.path] for leaf in leaves]
        kvs = [per_col.get(leaf.path) for leaf in leaves]
        device_cols = self._device_columns
        self._reset_builders()
        if self._pipeline is not None:
            try:
                est = sum(_estimate_input_bytes(b) for b in builders)
                self._pipeline.submit(builders, kvs, n_rows, est)
            except WriterError:
                raise
            except BaseException as e:
                self._failed = e
                self.abort()
                raise WriterError(
                    f"writer: background encode/flush failed: {e}"
                ) from e
            return
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
            self._pos = commit_group(erg, self._sink, self._pos, _metrics.codec_name(self._cfg.codec))
        except Exception as e:
            # the sink rejected bytes mid-group: _pos is out of sync with the
            # sink, so the writer can never produce a coherent file
            self._failed = e
            self.abort()
            raise WriterError(f"writer: flush failed: {e}") from e
        self._row_groups.append(erg.row_group)
        if self.write_page_index:
            self._page_indexes.append(erg.indexes)
        self._blooms.extend(erg.blooms)

    # -- lifecycle -------------------------------------------------------------

    def close(self) -> FileMetaData | None:
        """Flush, write blooms/page indexes/footer, and COMMIT the sink
        (atomic rename for path sinks). Idempotent: a second close returns
        the same FileMetaData. After a write fault (or abort) close() aborts
        instead (the destination never sees a half-written file) and
        returns None."""
        if self._closed:
            return self._meta
        if self._aborted:
            return None
        if self._failed is not None:
            # the failure was already raised to the caller: quiet abort
            self.abort()
            return None
        if self._pipeline is not None and self._pipeline.error is not None:
            # a background fault the caller has NOT seen yet: close() is
            # its last chance to surface; swallowing it would let a `with`
            # block exit cleanly with the destination silently missing
            e = self._pipeline.error
            self._failed = e
            self.abort()
            raise WriterError(
                f"writer: background encode/flush failed: {e}"
            ) from e
        try:
            self.flush_row_group()
            if self._pipeline is not None:
                try:
                    self._pipeline.drain()
                except BaseException as e:
                    self._failed = e
                    raise WriterError(
                        f"writer: background encode/flush failed: {e}"
                    ) from e
                self._row_groups = list(self._pipeline.row_groups)
                self._page_indexes = list(self._pipeline.page_indexes)
                self._blooms = list(self._pipeline.blooms)
                self._pos = self._pipeline.pos
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
        if self._own_pool is not None:
            self._own_pool.shutdown(wait=False)
        return meta

    def _write_tail(self) -> FileMetaData:
        """Bloom filters, then page index blobs, live between the last row
        group and the footer, with metadata fields pointing at them."""
        for md, bf in self._blooms:
            blob = bf.to_bytes()
            md.bloom_filter_offset = self._pos
            md.bloom_filter_length = len(blob)
            self._write(blob)
        self._blooms = []
        # (parquet-format PageIndex layout): all ColumnIndexes, then all
        # OffsetIndexes, with ColumnChunk fields pointing at them.
        for group in self._page_indexes:
            for cc, ci, _oi in group:
                blob = ci.dumps()
                cc.column_index_offset = self._pos
                cc.column_index_length = len(blob)
                self._write(blob)
        for group in self._page_indexes:
            for cc, _ci, oi in group:
                blob = oi.dumps()
                cc.offset_index_offset = self._pos
                cc.offset_index_length = len(blob)
                self._write(blob)
        self._page_indexes = []
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
        """Abandon the file: stop background encodes, discard the sink
        WITHOUT committing (the atomic path sink deletes its temp file; the
        destination is untouched). Idempotent, and a no-op after a
        successful close()."""
        if self._closed or self._aborted:
            return
        self._aborted = True
        if self._pipeline is not None:
            self._pipeline.abort()
        if self._own_pool is not None:
            self._own_pool.shutdown(wait=False)
        try:
            self._sink.abort()
        except Exception:
            pass  # abort is the error path: best-effort cleanup only

    @property
    def current_file_size(self) -> int:
        """Bytes written so far (reference: file_writer.go:362
        CurrentFileSize). Under `parallel=` this is the COMMITTED prefix —
        groups still encoding in the background are not counted yet."""
        if self._pipeline is not None and not self._closed:
            return self._pipeline.pos
        return self._pos

    @property
    def current_row_group_rows(self) -> int:
        return self._shredder.num_rows or (self._columnar_rows or 0)

    @property
    def current_row_group_size(self) -> int:
        """Rough UNCOMPRESSED size of the buffered (unflushed) row group —
        the size-based flush signal (reference: file_writer.go:355
        CurrentRowGroupSize); the flushed bytes will usually be smaller
        once encoded and compressed. Covers both ingestion paths: shredded
        rows still in the Shredder plus columnar data in the builders."""
        return self._estimated_size() + sum(
            b.data_size() for b in self._builders.values()
        )

    def _check_open(self) -> None:
        if self._failed is not None:
            raise WriterError(
                "writer: an earlier write failed; the writer is unusable "
                "(the output was not committed)"
            ) from self._failed
        if self._closed or self._aborted:
            raise WriterError("writer: already closed")
        if self._pipeline is not None and self._pipeline.error is not None:
            # deferred propagation: a background encode/flush fault
            # surfaces on the NEXT writer call, and the output is torn down
            e = self._pipeline.error
            self._failed = e
            self.abort()
            raise WriterError(
                f"writer: background encode/flush failed: {e}"
            ) from e

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *rest):
        if exc_type is None:
            # close() surfaces any still-unseen background fault as
            # WriterError (and quietly aborts only when the fault was
            # already raised to the caller)
            self.close()
        else:
            # an exception inside the `with` must NOT commit a half-written
            # file: tear down the temp file instead
            self.abort()
        return False


def _estimate_input_bytes(builder: ColumnChunkBuilder) -> int:
    """Approximate buffered bytes of one chunk for the pipeline's
    backpressure accounting. Exact for array inputs (nbytes); for long
    Python value lists a 64-point sample extrapolates instead of walking
    every element."""
    for v in (builder._columnar_values, builder.values):
        if isinstance(v, list) and len(v) > 256:
            step = max(len(v) // 64, 1)
            sample = v[::step][:64]
            per = sum(
                len(x) + 4 if isinstance(x, (bytes, str)) else 8 for x in sample
            ) / max(len(sample), 1)
            return int(per * len(v)) + 2 * len(builder.def_levels)
    return builder.data_size()
