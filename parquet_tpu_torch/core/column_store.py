"""Write-side column stores: typed buffering and the dictionary decision.

A copy of parquet_tpu/core/column_store.py, cut to the columnar half of
`ColumnChunkBuilder` that FileWriter.write_column needs: `set_columnar`,
`typed_values`, `fast_dictionary` and `build_dictionary`. The row path
(`extend_shredded`, the Shredder's values) and pyarrow ingestion
(`_from_arrow`) are left out, and so is the conversion of row-domain objects
(datetime, Decimal) to storage: the port has no host row assembly yet.

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

import numpy as np

from ..meta.parquet_types import Type
from .arrays import ByteArrayData
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
        self.def_levels: list[int] = []
        self.rep_levels: list[int] = []
        self._columnar_values = None  # fast-path ndarray/ByteArrayData

    def _n_values(self) -> int:
        return 0 if self._columnar_values is None else len(self._columnar_values)

    # -- ingestion -------------------------------------------------------------

    def set_columnar(self, values, def_levels=None, rep_levels=None) -> None:
        """Columnar fast path: typed array (+ optional levels) for the chunk."""
        if len(self.def_levels) or self._columnar_values is not None:
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
        return self._coerce_array([] if self._columnar_values is None else self._columnar_values)

    def _coerce_array(self, v):
        ptype = self.column.type
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
            return ByteArrayData.from_list([self._to_bytes(x) for x in v])
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
        raw = self._columnar_values
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
