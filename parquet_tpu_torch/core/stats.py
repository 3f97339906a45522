"""Column statistics: min/max/null-count of a chunk, and unsigned order.

A copy of parquet_tpu/core/stats.py, cut to what the port uses:
`column_is_unsigned` (the filters decode statistics with it) and
`compute_statistics` (testing/synth.py writes each chunk's statistics with
it, so its files prune as the JAX writer's do). A byte-array column's
min/max is one scan of the port's host library (ptq_bytes_minmax), as the
JAX module's is; `bytes_minmax_plain` is its oracle. Written into both the
legacy (min/max) and modern (min_value/max_value) Statistics fields,
matching what current writers emit for TypeDefinedOrder columns.
"""

from __future__ import annotations

import struct

import numpy as np

from ..meta.parquet_types import ConvertedType, Statistics, Type
from .arrays import ByteArrayData

__all__ = ["compute_statistics", "column_is_unsigned", "bytes_minmax_plain"]

_PACK = {
    Type.INT32: struct.Struct("<i"),
    Type.INT64: struct.Struct("<q"),
    Type.FLOAT: struct.Struct("<f"),
    Type.DOUBLE: struct.Struct("<d"),
}

_PACK_UNSIGNED = {
    Type.INT32: struct.Struct("<I"),
    Type.INT64: struct.Struct("<Q"),
}

_UINT_VIEW = {Type.INT32: np.uint32, Type.INT64: np.uint64}

_UNSIGNED_CTS = (
    ConvertedType.UINT_8,
    ConvertedType.UINT_16,
    ConvertedType.UINT_32,
    ConvertedType.UINT_64,
)


def column_is_unsigned(column) -> bool:
    """Whether a leaf's logical/converted type makes its order UNSIGNED —
    min/max must then be computed over the unsigned interpretation
    (parquet-format TypeDefinedOrder for UINT_8..UINT_64)."""
    lt = column.logical_type
    if lt is not None and lt.INTEGER is not None:
        return not lt.INTEGER.isSigned
    ct = column.converted_type
    return ct is not None and ct in _UNSIGNED_CTS


# Cap stored min/max byte length, as modern writers do for wide binary values.
_MAX_STAT_BYTES = 64


def compute_statistics(
    ptype: Type, values, null_count: int, unsigned: bool = False
) -> Statistics:
    """Build Statistics for one page or chunk. `values` holds non-null
    cells. `unsigned=True` (UINT logical/converted types) compares and
    packs min/max in the unsigned domain — the column's defined order; the
    deprecated min/max fields are then left unset (they are specified as
    signed-compared, so an unsigned pair there would mislead old readers)."""
    st = Statistics(null_count=null_count)
    n = len(values) if values is not None else 0
    if n == 0:
        return st
    if unsigned and ptype in _PACK_UNSIGNED:
        arr = np.asarray(values).view(_UINT_VIEW[ptype])
        pk = _PACK_UNSIGNED[ptype]
        st.min_value = pk.pack(int(arr.min()))
        st.max_value = pk.pack(int(arr.max()))
        return st
    if ptype in _PACK:
        arr = np.asarray(values)
        if ptype in (Type.FLOAT, Type.DOUBLE):
            finite = arr[~np.isnan(arr)]
            if finite.size == 0:
                return st  # all-NaN: no stats (NaN order undefined)
            mn, mx = finite.min(), finite.max()
            # ±0.0 normalization like modern writers: report min as -0.0 and
            # max as +0.0 so either sign of zero is covered by the range.
            if mn == 0.0:
                mn = arr.dtype.type(-0.0)
            if mx == 0.0:
                mx = arr.dtype.type(0.0)
        else:
            mn, mx = arr.min(), arr.max()
        pk = _PACK[ptype]
        st.min_value = pk.pack(mn)
        st.max_value = pk.pack(mx)
    elif ptype == Type.BOOLEAN:
        arr = np.asarray(values, dtype=bool)
        st.min_value = bytes([int(arr.min())])
        st.max_value = bytes([int(arr.max())])
    elif ptype in (Type.BYTE_ARRAY, Type.FIXED_LEN_BYTE_ARRAY):
        if isinstance(values, ByteArrayData):
            from ..utils.native import get_native

            # one C scan over (offsets, data), no Python object per value;
            # bytes_minmax_plain is its oracle
            i_mn, i_mx = get_native().bytes_minmax(values.data, values.offsets)
            mn, mx = values[i_mn], values[i_mx]
        else:
            if isinstance(values, np.ndarray) and values.ndim == 2:
                items = [v.tobytes() for v in values]
            else:
                items = [bytes(v) for v in values]
            mn = min(items)
            mx = max(items)
        st.min_value, exact_min = _truncate_min(mn)
        st.max_value, exact_max = _truncate_max(mx)
        if not (exact_min and exact_max):
            # truncated bounds are still valid for range pruning; the
            # exactness flags tell readers not to treat them as values
            st.is_min_value_exact = exact_min
            st.is_max_value_exact = exact_max
            st.min = st.max = None  # legacy fields carry no exactness flag
            return st
    else:
        return st  # INT96: no meaningful order (reference nilStats analogue)
    # Legacy fields mirror the modern ones (TypeDefinedOrder).
    st.min = st.min_value
    st.max = st.max_value
    return st


def bytes_minmax_plain(values: ByteArrayData) -> tuple[int, int]:
    """(row of the lexicographic min, row of the max), each the first such
    row, by Python comparisons: the oracle the tests hold ptq_bytes_minmax
    against."""
    items = values.to_list()
    rows = range(len(items))
    return min(rows, key=items.__getitem__), max(rows, key=items.__getitem__)


def _truncate_min(raw: bytes):
    """(possibly truncated lower bound, is_exact): a prefix of the min is
    always <= the min, so plain truncation is a valid lower bound."""
    if len(raw) <= _MAX_STAT_BYTES:
        return raw, True
    return raw[:_MAX_STAT_BYTES], False


def _truncate_max(raw: bytes):
    """(possibly truncated-and-incremented upper bound, is_exact): the
    prefix alone would UNDERSTATE the max, so the last non-0xFF byte of the
    prefix increments; an all-0xFF prefix cannot be incremented and the
    bound is dropped (None) rather than made unsound."""
    if len(raw) <= _MAX_STAT_BYTES:
        return raw, True
    prefix = bytearray(raw[:_MAX_STAT_BYTES])
    for i in range(len(prefix) - 1, -1, -1):
        if prefix[i] != 0xFF:
            prefix[i] += 1
            return bytes(prefix[: i + 1]), False
    return None, False
