"""Write-side column stores: typed buffering and the dictionary decision.

A copy of parquet_tpu/core/column_store.py. A `ColumnChunkBuilder` takes a
chunk either columnar (`set_columnar`, FileWriter.write_column: NumPy
arrays, value lists, or the port's Arrow arrays of core/arrow_format.py,
ingested at the buffer level by `_from_arrow` where the reference ingests
pyarrow's) or as the Shredder's row values
(`extend_shredded`, FileWriter.write_row / write_rows); row-domain objects
(datetime, date, time, Decimal, floor.Time, unsigned ints past the signed
range) convert to storage by the leaf's logical type (core/assembly.py
convert_to_storage), and `data_size` is the size signal of the row-group
auto-flush.

Dictionaries are probed as the JAX module probes them: one C hash probe of
the port's host library in first-occurrence order, over the byte-array
column's (offsets, data) (ptq_bytes_dict_indices) or the numeric column's
bit patterns (ptq_u64_dict_indices), each stopping past the cutoff. Their
oracles are a Python dict loop (`_bytes_first_occurrence_dictionary`) and
NumPy (`_first_occurrence_dictionary`: `np.unique` of the bit patterns, the
uniques ranked by first occurrence). The str-domain probe of
`fast_dictionary` stays a Python dict loop. The dictionary order, the
indices and every page byte equal the JAX writer's.

Defaults carried from the reference: 1 MiB max page size (data_store.go:149-154),
dictionary cutoff 32767 uniques (chunk_writer.go:188-200, type_dict.go:101-103).
"""

from __future__ import annotations

import datetime as _dt

import numpy as np

from ..meta.parquet_types import Type
from .arrays import ByteArrayData, byte_array_from_items
from .schema import Column

__all__ = [
    "ColumnChunkBuilder",
    "StoreError",
    "MAX_PAGE_SIZE_DEFAULT",
    "DICT_MAX_UNIQUES",
    "PROBE_NA",
]

MAX_PAGE_SIZE_DEFAULT = 1 << 20  # 1 MiB, reference data_store.go:149-154
DICT_MAX_UNIQUES = (1 << 15) - 1  # 32767, reference chunk_writer.go:188-200

# fast_dictionary's "probe not applicable" sentinel (distinct from None,
# which is the definitive "dictionary encoding does not pay" verdict)
PROBE_NA = object()


class StoreError(ValueError):
    pass


_NUMERIC = {
    Type.INT32: np.int32,
    Type.INT64: np.int64,
    Type.FLOAT: np.float32,
    Type.DOUBLE: np.float64,
}

_TYPE_WIDTHS = {
    Type.INT32: 4, Type.INT64: 8, Type.FLOAT: 4, Type.DOUBLE: 8,
    Type.BOOLEAN: 1, Type.INT96: 12,
}


def _is_arrow(v) -> bool:
    """An Arrow array of the port's (core/arrow_format), the write_column
    input the reference takes as a pyarrow array."""
    from .arrow_format import Array, ChunkedArray

    return isinstance(v, (Array, ChunkedArray))


def _first_occurrence_dictionary(bits: np.ndarray):
    """(firsts, indices) of a 1-D array's first-occurrence dictionary: entry k
    is bits[firsts[k]], the k-th distinct value in row order, and indices[i]
    (uint32) is row i's entry. The order of the JAX package's native probe
    (ptq_u64_dict_indices), computed from np.unique's sorted groups."""
    _uniq, first, inverse = np.unique(bits, return_index=True, return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty(len(order), dtype=np.uint32)
    rank[order] = np.arange(len(order), dtype=np.uint32)
    return first[order], rank[inverse.reshape(-1)]


def _bytes_first_occurrence_dictionary(typed: ByteArrayData):
    """(firsts, indices) of a byte-array column's first-occurrence
    dictionary by a Python dict loop, or None past DICT_MAX_UNIQUES: the
    oracle the tests hold ptq_bytes_dict_indices against."""
    uniq: dict[bytes, int] = {}
    firsts: list[int] = []
    indices = np.empty(len(typed), dtype=np.uint32)
    uniq_get = uniq.get
    for i, key in enumerate(typed.to_list()):
        idx = uniq_get(key)
        if idx is None:
            idx = len(uniq)
            if idx >= DICT_MAX_UNIQUES:
                return None
            uniq[key] = idx
            firsts.append(i)
        indices[i] = idx
    return np.array(firsts, dtype=np.uint32), indices


class ColumnChunkBuilder:
    """Buffers one column's values + levels for the current row group."""

    def __init__(self, column: Column, enable_dict: bool = True):
        self.column = column
        self.enable_dict = enable_dict
        self.values: list = []
        self.def_levels: list[int] = []
        self.rep_levels: list[int] = []
        self._columnar_values = None  # fast-path ndarray/ByteArrayData

    def __len__(self) -> int:
        return len(self.def_levels) if len(self.def_levels) else self._n_values()

    def _n_values(self) -> int:
        if self._columnar_values is not None:
            return len(self._columnar_values)
        return len(self.values)

    def data_size(self) -> int:
        """Rough UNCOMPRESSED byte size of the buffered values + levels
        (reference: data_store.go DataSize via file_writer.go:355
        CurrentRowGroupSize) — the signal callers use for size-based
        row-group flushing; encoding/compression usually shrink it."""
        n = len(self)
        size = n * 2 * (
            (self.column.max_def > 0) + (self.column.max_rep > 0)
        )
        v = self._columnar_values
        if v is not None:
            if isinstance(v, ByteArrayData):
                return size + len(v.data) + 4 * len(v)
            nb = getattr(v, "nbytes", None)
            if nb is not None:
                return size + int(nb)
            v = list(v)
        else:
            v = self.values
        if not v:
            return size
        first = v[0]
        if isinstance(first, (bytes, str)):
            return size + sum(len(x) for x in v) + 4 * len(v)
        width = self.column.type_length or _TYPE_WIDTHS.get(self.column.type, 8)
        return size + len(v) * width

    # -- ingestion -------------------------------------------------------------

    def extend_shredded(self, values: list, def_levels: list, rep_levels: list) -> None:
        """Row-path input from the Shredder (values include None placeholders)."""
        self.values.extend(v for v in values if v is not None)
        self.def_levels.extend(def_levels)
        self.rep_levels.extend(rep_levels)

    def set_columnar(self, values, def_levels=None, rep_levels=None) -> None:
        """Columnar fast path: typed array (+ optional levels) for the chunk."""
        if self.values or len(self.def_levels) or self._columnar_values is not None:
            raise StoreError(
                "store: column already holds data for this row group"
            )
        self._columnar_values = values
        # keep level arrays as ndarrays: a list() round-trip boxes 1 value
        # per cell and every consumer re-asarrays anyway
        self.def_levels = (
            np.asarray(def_levels, dtype=np.uint16) if def_levels is not None else []
        )
        self.rep_levels = (
            np.asarray(rep_levels, dtype=np.uint16) if rep_levels is not None else []
        )

    # -- typed conversion ------------------------------------------------------

    def typed_values(self):
        """Non-null cells as a typed array / ByteArrayData."""
        if self._columnar_values is not None:
            return self._coerce_array(self._columnar_values)
        ptype = self.column.type
        if ptype in _NUMERIC:
            # same exact-roundtrip validation as the columnar path: a float
            # 1.5 must not silently truncate into an int64 column
            return self._coerce_array(self.values)
        if ptype == Type.BOOLEAN:
            return np.asarray(self.values, dtype=bool)
        vals = self.values
        if vals and not isinstance(vals[0], (bytes, str)):
            # row-domain objects (e.g. Decimal into FLBA/BYTE_ARRAY
            # storage) convert by the leaf's logical annotation; datetimes
            # for INT96 pass through untouched (handled below)
            from .assembly import convert_to_storage, logical_kind

            k = logical_kind(self.column)
            if k is not None and k != "int96":
                try:
                    vals = [convert_to_storage(self.column, x, k) for x in vals]
                except ValueError as e:
                    raise StoreError(
                        f"store: {self.column.path_str}: {e}"
                    ) from e
        if ptype == Type.BYTE_ARRAY:
            return byte_array_from_items(vals, to_bytes=self._to_bytes)
        if ptype in (Type.INT96, Type.FIXED_LEN_BYTE_ARRAY):
            width = 12 if ptype == Type.INT96 else (self.column.type_length or 0)
            if width <= 0:
                raise StoreError(
                    f"store: fixed column {self.column.path_str} lacks type_length"
                )
            rows = []
            for v in vals:
                if ptype == Type.INT96 and isinstance(v, _dt.datetime):
                    # datetime into an INT96 column converts like the
                    # reference's floor writer (writer.go INT96 heuristics)
                    from ..utils.int96 import datetime_to_int96

                    v = datetime_to_int96(v)
                b = self._to_bytes(v)
                if len(b) != width:
                    raise StoreError(
                        f"store: fixed({width}) column {self.column.path_str} "
                        f"got {len(b)}-byte value"
                    )
                rows.append(np.frombuffer(b, dtype=np.uint8))
            if not rows:
                return np.empty((0, width), dtype=np.uint8)
            return np.stack(rows)
        raise StoreError(f"store: unsupported type {ptype}")

    def _from_arrow(self, v):
        """An Arrow Array / ChunkedArray (core/arrow_format) -> the columnar
        containers, zero-copy where the layouts agree (numeric buffers,
        string offsets): handing write_column an Arrow array skips the
        per-item Python string encode entirely."""
        from . import arrow_format as pa

        if isinstance(v, pa.ChunkedArray):
            v = v.combine_chunks()
        if not isinstance(v, pa.Array):
            raise StoreError(
                f"store: unsupported arrow input {type(v).__name__} for "
                f"{self.column.path_str}"
            )
        t = v.type
        if pa.types.is_dictionary(t):
            v = v.dictionary_decode()
            t = v.type
        # null check AFTER dictionary decode: a dictionary array carrying
        # nulls in its VALUE buffer reports no null on the indices
        if v.null_count:
            raise StoreError(
                f"store: arrow array for {self.column.path_str} contains "
                "nulls; write_column takes non-null cells (pass def_levels "
                "explicitly, or drop/fill nulls upstream)"
            )
        k = t.kind
        if k in ("string", "binary", "large_string", "large_binary"):
            off = v.offsets_np()
            base = int(off[0]) if len(off) else 0
            end = int(off[-1]) if len(off) else 0
            # data stays `bytes` (ByteArrayData contract: slices hash)
            data = v.data_np()[base:end].tobytes()
            offsets = off - base if base else off
            return ByteArrayData(offsets=offsets, data=data)
        if k == "fixed_size_binary":
            return v.values_np()
        if k == "bool":
            return v.values_np()  # bit-packed in arrow: unpack copy
        if pa.types.is_temporal(t):
            # temporal values pass through as their integer representation;
            # the schema annotation (TIMESTAMP(unit) etc.) defines meaning
            return v.values_np()
        if k == "decimal128":
            # unscaled 128-bit LE two's complement -> the column's physical
            # storage (the reverse of to_arrow's decimal128 widening). The
            # array's scale must MATCH the column's declared scale, and
            # every value must FIT the narrower storage.
            decl_scale = self.column.element.scale
            lt = self.column.logical_type
            if lt is not None and lt.DECIMAL is not None:
                decl_scale = lt.DECIMAL.scale
            if decl_scale is not None and t.scale != decl_scale:
                raise StoreError(
                    f"store: decimal scale mismatch for "
                    f"{self.column.path_str}: array has scale {t.scale}, "
                    f"column declares {decl_scale}"
                )
            n = len(v)
            m = v.values_np()
            ptype = self.column.type
            if ptype in (Type.INT32, Type.INT64):
                lohi = np.ascontiguousarray(m).view("<i8").reshape(n, 2)
                lo = lohi[:, 0]
                if not bool((lohi[:, 1] == (lo >> 63)).all()):
                    raise StoreError(
                        f"store: decimal value does not fit 64-bit storage "
                        f"of {self.column.path_str}"
                    )
                if ptype == Type.INT64:
                    return lo.copy()
                lo32 = lo.astype(np.int32)
                if not bool((lo32 == lo).all()):
                    raise StoreError(
                        f"store: decimal value does not fit INT32 storage "
                        f"of {self.column.path_str}"
                    )
                return lo32
            if ptype == Type.FIXED_LEN_BYTE_ARRAY:
                w = self.column.type_length or 0
                if 1 <= w <= 16:
                    if w < 16:
                        # dropped high bytes must be pure sign extension
                        sign = np.where(m[:, w - 1] >= 0x80, 0xFF, 0).astype(
                            np.uint8
                        )
                        if not bool((m[:, w:] == sign[:, None]).all()):
                            raise StoreError(
                                f"store: decimal value does not fit "
                                f"{w}-byte storage of {self.column.path_str}"
                            )
                    return np.ascontiguousarray(m[:, :w][:, ::-1])  # LE -> BE
                if w > 16:
                    out = np.zeros((n, w), dtype=np.uint8)
                    out[:, w - 16 :] = m[:, ::-1]
                    out[m[:, 15] >= 0x80, : w - 16] = 0xFF  # sign fill
                    return out
        if k == "float" and t.bit_width == 16:
            return v.values_np().view(np.uint8).reshape(len(v), 2)
        try:
            return v.to_numpy(zero_copy_only=True)
        except (pa.ArrowInvalid, pa.ArrowTypeError) as e:
            raise StoreError(
                f"store: cannot ingest arrow {t} array for "
                f"{self.column.path_str}: {e}"
            ) from e

    def _coerce_array(self, v):
        ptype = self.column.type
        if isinstance(v, list) and v:
            # row-domain objects (datetime/date/time/Decimal — what
            # iter_rows RETURNS) convert to storage by the leaf's logical
            # annotation; raw storage lists skip on the first-element
            # check. UINT columns also wrap plain ints >= 2^(bits-1) into
            # their signed storage bit pattern.
            first = v[0]
            needs = not isinstance(first, (int, float, str, bytes))
            if (
                not needs
                and isinstance(first, int)
                and ptype in (Type.INT32, Type.INT64)
            ):
                from .assembly import logical_kind

                k = logical_kind(self.column)
                needs = k is not None and k[0] == "uint"
            if needs:
                from .assembly import convert_to_storage, logical_kind

                k = logical_kind(self.column)
                if k is not None:
                    try:
                        v = [
                            convert_to_storage(self.column, x, k) for x in v
                        ]
                    except ValueError as e:
                        raise StoreError(
                            f"store: {self.column.path_str}: {e}"
                        ) from e
        if _is_arrow(v):
            v = self._from_arrow(v)
            if isinstance(v, ByteArrayData):
                if ptype != Type.BYTE_ARRAY:
                    raise StoreError(
                        f"store: string/binary arrow array into non-BYTE_ARRAY "
                        f"column {self.column.path_str}"
                    )
                return v
        if ptype in _NUMERIC:
            try:
                arr = np.asarray(v)
            except (ValueError, OverflowError, TypeError) as e:
                raise StoreError(
                    f"store: bad value for {ptype.name} column "
                    f"{self.column.path_str}: {e}"
                ) from e
            if arr.ndim != 1 or arr.dtype.kind not in "iufb":
                raise StoreError(
                    f"store: {ptype.name} column {self.column.path_str} takes "
                    f"a flat numeric array, got ndim={arr.ndim} dtype={arr.dtype}"
                )
            want = _NUMERIC[ptype]
            if arr.dtype != want:
                with np.errstate(invalid="ignore"):
                    try:
                        cast = arr.astype(want)
                    except (ValueError, OverflowError, TypeError) as e:
                        raise StoreError(
                            f"store: bad value for {ptype.name} column "
                            f"{self.column.path_str}: {e}"
                        ) from e
                # Any implicit cast must round-trip exactly (catches integer
                # overflow, fractional floats into int columns, NaN into ints,
                # and lossy f64 -> f32).
                both_float = arr.dtype.kind == "f" and np.dtype(want).kind == "f"
                if not np.array_equal(cast.astype(arr.dtype), arr, equal_nan=both_float):
                    raise StoreError(
                        f"store: values do not fit {ptype.name} exactly in "
                        f"{self.column.path_str} (dtype {arr.dtype})"
                    )
                arr = cast
            return arr
        if ptype == Type.BOOLEAN:
            return np.asarray(v, dtype=bool)
        if ptype == Type.BYTE_ARRAY:
            if isinstance(v, ByteArrayData):
                return v
            return byte_array_from_items(v, to_bytes=self._to_bytes)
        if isinstance(v, (list, tuple)) and (not v or isinstance(v[0], bytes)):
            width = 12 if ptype == Type.INT96 else (self.column.type_length or 0)
            if width <= 0 or any(
                not isinstance(x, bytes) or len(x) != width for x in v
            ):
                raise StoreError(
                    f"store: fixed({width}) column {self.column.path_str} "
                    f"takes {width}-byte values"
                )
            return np.frombuffer(b"".join(v), dtype=np.uint8).reshape(len(v), width)
        arr = np.asarray(v, dtype=np.uint8)
        if arr.ndim != 2:
            raise StoreError("store: fixed-width columnar input must be (n, width)")
        return arr

    @staticmethod
    def _to_bytes(v) -> bytes:
        if isinstance(v, bytes):
            return v
        if isinstance(v, str):
            return v.encode("utf-8")
        if isinstance(v, (bytearray, memoryview, np.ndarray)):
            return bytes(v)
        raise StoreError(f"store: cannot convert {type(v).__name__} to bytes")

    # -- dictionary decision (whole-chunk, reference: chunk_writer.go:174-209) --

    def fast_dictionary(self):
        """OBJECT-domain dictionary probe for string columns: dedup the
        Python str values BEFORE any UTF-8 materialization, so a
        dictionary-encoded chunk only ever byte-encodes its (few) uniques.
        Byte-identical to probing the encoded bytes (str -> UTF-8 is
        injective, so uniques, first-occurrence order and the dict-vs-plain
        size cutoff all coincide); a non-str item ends the probe, since
        object and byte equality diverge there. The JAX module runs this
        probe in its C extension; here it is a Python dict loop.

        Returns (dict_values, indices) when dictionary encoding pays, None
        when it provably does not (the caller must NOT re-probe), or the
        PROBE_NA sentinel when the probe does not apply (non-list input,
        non-BYTE_ARRAY column, a non-str item — take build_dictionary)."""
        if not self.enable_dict or self.column.type != Type.BYTE_ARRAY:
            return PROBE_NA
        raw = self._columnar_values if self._columnar_values is not None else self.values
        if not isinstance(raw, list) or not raw:
            return PROBE_NA
        uniq: dict[str, int] = {}
        indices = np.empty(len(raw), dtype=np.uint32)
        for i, s in enumerate(raw):
            if type(s) is not str:
                return PROBE_NA  # byte-domain path decides
            k = uniq.get(s)
            if k is None:
                k = len(uniq)
                if k >= DICT_MAX_UNIQUES:
                    return None  # uniques exceed the cutoff: dict never pays
                uniq[s] = k
            indices[i] = k
        encoded = [u.encode("utf-8") for u in uniq]
        lens = np.fromiter(map(len, encoded), dtype=np.int64, count=len(encoded))
        n = len(raw)
        # the exact size cutoff of build_dictionary's byte-array branch
        plain_size = int(lens[indices].sum()) + 4 * n
        dict_size = int(lens.sum()) + 4 * len(encoded) + n * 4
        if dict_size >= plain_size:
            return None
        return ByteArrayData.from_list(encoded), indices

    def build_dictionary(self, typed):
        """Return (dict_values, indices) or None if dict encoding doesn't pay."""
        if not self.enable_dict:
            return None
        ptype = self.column.type
        n = len(typed)
        if n == 0:
            return None
        from ..utils.native import get_native

        if isinstance(typed, ByteArrayData):
            # C hash probe straight over (offsets, data): no Python object
            # per value
            res = get_native().bytes_dict_indices(typed.data, typed.offsets, DICT_MAX_UNIQUES)
            if res is None:
                return None  # more uniques than the cutoff: dict never pays
            firsts, indices = res
            dict_values = typed.take(firsts.astype(np.int64))
            plain_size = len(typed.data) + 4 * n
            dict_size = len(dict_values.data) + 4 * len(firsts) + n * 4
        elif isinstance(typed, np.ndarray) and typed.ndim == 1 and ptype != Type.BOOLEAN:
            # Bit-pattern uniqueness so NaN payloads dedup correctly
            # (reference CHANGELOG.md:31 NaN-in-dict fix). The C probe exits
            # early past the cutoff: no sort of a high-cardinality column.
            bits = typed.view(np.uint32 if typed.itemsize == 4 else np.uint64)
            res = get_native().u64_dict_indices(bits, DICT_MAX_UNIQUES)
            if res is None:
                return None
            firsts, indices = res
            dict_values = typed[firsts.astype(np.int64)]
            width = max(int(len(firsts) - 1).bit_length(), 1)
            plain_size = typed.nbytes
            dict_size = dict_values.nbytes + (n * width) // 8
        else:
            return None  # boolean / fixed-width: dict rarely pays
        if dict_size >= plain_size:
            return None
        return dict_values, indices
