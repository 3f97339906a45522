"""Aggregation push-down: per-unit partials, exact merge, canonical body.

The port of parquet_tpu/serve/aggregate.py, without pyarrow. Each unit (one
row group of one file) computes a PARTIAL aggregate, partials merge with
exact semantics, and the response is kilobytes however many rows matched.
A unit runs on the reference's ladder: the device first
(serve/query_device.device_unit_partial), and a unit outside the device
envelope (group_by, a float, decimal, bool, string or temporal aggregate,
a repeated column) on the host engine below, counted as the reference
counts it (query_device_counts(): "device", "host_fallback").

The host engine is the reference's pyarrow engine (unit_partial over
to_arrow) written out over the port's host unit table
(core/unit_table.HostUnitTable, FileReader._host_unit_table), held against
pyarrow by the tests:

  * types are tagged with the names of the reference's arrow types
    (arrow_type_tag): a sum is int64 / uint64 over integers, uint64 over
    booleans, double over floats, decimal128(38, s) over decimals, and min
    and max keep the column's type. A shape pyarrow has no kernel for (a
    string or temporal sum, a half-float or struct min, a group-by key
    that is a struct or a list) is the reference's 400 bad_aggregates;
  * a global float sum is Arrow's pairwise sum of one chunk
    (_arrow_float_sum), a grouped one the sequential sum in row order from
    0.0 (np.bincount); integer sums wrap in 64 bits; decimals sum exactly;
  * min and max skip NaN unless every value is NaN, compare strings and
    binaries by their bytes and decimals and temporals by their physical
    integers; count skips nulls and counts NaN;
  * group keys factorize in order of first occurrence (the port's native
    dictionary probes, capped at max_groups): floats by their bits with
    every NaN one group and -0.0 apart from 0.0, null a group of its own.
    Keys and results convert to the Python values the reference's as_py()
    gives (Decimal, date, datetime, time; timestamp[ns] as NanoTimestamp,
    rendered as pandas renders it).

The reference merges two partials with the pyarrow kernel of the partial's
arrow type over a two-element array; _merge_value writes that kernel out
per type tag, and infers the type of an untyped pair (the mesh router's
partials, parsed from replica bodies) as pyarrow's array inference would.

run_local_query is the daemon-free runner: units are the row groups each
file's statistics and bloom filters admit, file by file in sorted order
(data/plan.build_plan), striped over shards with `shard=`. A count(*)-only
query without filters answers from the footer.

The canonical JSON rendering (render_query_body) is the reference's, so
the bodies are its bytes for the same corpus and spec.
"""

from __future__ import annotations

import datetime
import decimal
import json
import math
from contextlib import ExitStack

import numpy as np

from ..core.arrow_format import NanoTimestamp
from ..core.arrays import ByteArrayData
from ..core.filter_vec import VecFilterError
from ..core.unit_table import list_like
from ..meta.parquet_types import ConvertedType, Type
from ..utils.counters import LabelledCounts
from ..utils.native import get_native
from .protocol import QueryRequest, ServeError, agg_name, filter_not_ported, json_default
from .query_device import DeviceQueryError, device_unit_partial

__all__ = [
    "QueryState",
    "NanoTimestamp",
    "arrow_type_tag",
    "query_columns",
    "unit_partial",
    "host_unit_partial",
    "unit_count_partial",
    "result_dict",
    "render_query_body",
    "run_local_query",
    "query_device_counts",
    "reset_query_device_counts",
]

_M64 = (1 << 64) - 1

# Units by engine, as the reference counts query_device_units_total{engine=}:
# "device" (device_unit_partial answered) and "host_fallback" (the device
# declined the unit with DeviceQueryError and the host engine answered it).
_COUNTS = LabelledCounts(
    alias=lambda engine, labels: ("query_device_units_total", {"engine": engine})
)


def query_device_counts() -> dict:
    """A snapshot of the query units' engine counts."""
    return _COUNTS.snapshot()


def reset_query_device_counts() -> None:
    _COUNTS.reset()


def _bump(engine: str) -> None:
    _COUNTS.count(engine)


def query_columns(query: QueryRequest) -> list:
    """The column projection a query's units must decode: group-by keys
    plus aggregate inputs, order-stable. Empty + no filters means NO decode
    at all (pure count(*) answers from footer-promised row counts); empty
    WITH filters borrows the first filter column so the filtered row count
    is still observable."""
    cols: list = []
    for c in query.group_by:
        if c not in cols:
            cols.append(c)
    for a in query.aggregates:
        if a.column is not None and a.column not in cols:
            cols.append(a.column)
    if not cols and query.filters is not None:
        first = query.filters[0]
        if isinstance(first, (list, tuple)) and first and isinstance(
            first[0], (list, tuple)
        ):
            first = first[0]  # DNF: first conjunction's first triple
        cols.append(first[0])
    return cols


def unit_count_partial(query: QueryRequest, num_rows: int):
    """The zero-decode partial: every aggregate is count(*) (query_columns
    returned empty with no filters), so the footer-promised row count IS
    the answer and the unit never opens its file."""
    return {(): [num_rows for _ in query.aggregates]}, [None] * len(
        query.aggregates
    )


# -- the host engine: arrow types ------------------------------------------------------

_STORAGE_TAGS = {
    Type.INT32: "int32", Type.INT64: "int64", Type.FLOAT: "float",
    Type.DOUBLE: "double", Type.BOOLEAN: "bool",
}
_INT_TAGS = {
    (8, True): "int8", (16, True): "int16", (32, True): "int32", (64, True): "int64",
    (8, False): "uint8", (16, False): "uint16", (32, False): "uint32", (64, False): "uint64",
}
_CONVERTED_TAGS = {
    (ConvertedType.DATE, Type.INT32): "date32[day]",
    (ConvertedType.TIME_MILLIS, Type.INT32): "time32[ms]",
    (ConvertedType.TIME_MICROS, Type.INT64): "time64[us]",
    (ConvertedType.TIMESTAMP_MILLIS, Type.INT64): "timestamp[ms]",
    (ConvertedType.TIMESTAMP_MICROS, Type.INT64): "timestamp[us]",
}
_CONVERTED_INTS = {
    ConvertedType.UINT_8: (8, False), ConvertedType.UINT_16: (16, False),
    ConvertedType.UINT_32: (32, False), ConvertedType.UINT_64: (64, False),
    ConvertedType.INT_8: (8, True), ConvertedType.INT_16: (16, True),
}


def _decimal_tag(leaf, precision, scale):
    if precision is None or not 1 <= precision <= 38:
        return None
    if leaf.type in (Type.INT32, Type.INT64) or (
        leaf.type == Type.FIXED_LEN_BYTE_ARRAY and 1 <= (leaf.type_length or 0) <= 16
    ):
        return f"decimal128({precision}, {scale or 0})"
    return None


def _logical_tag(leaf):
    t, lt, ct = leaf.type, leaf.logical_type, leaf.converted_type
    if lt is not None:
        if lt.TIMESTAMP is not None and t == Type.INT64:
            u = lt.TIMESTAMP.unit
            unit = "ms" if u and u.MILLIS is not None else "ns" if u and u.NANOS is not None else "us"
            return f"timestamp[{unit}, tz=UTC]" if lt.TIMESTAMP.isAdjustedToUTC else f"timestamp[{unit}]"
        if lt.TIME is not None:
            u = lt.TIME.unit
            if u is not None and u.MILLIS is not None:
                return "time32[ms]" if t == Type.INT32 else None
            if u is not None and u.MICROS is not None:
                return "time64[us]" if t == Type.INT64 else None
            if u is not None and u.NANOS is not None:
                return "time64[ns]" if t == Type.INT64 else None
            return None
        if lt.DATE is not None and t == Type.INT32:
            return "date32[day]"
        if lt.DECIMAL is not None:
            return _decimal_tag(leaf, lt.DECIMAL.precision, lt.DECIMAL.scale)
        if lt.INTEGER is not None:
            return _INT_TAGS.get((lt.INTEGER.bitWidth, bool(lt.INTEGER.isSigned)))
        if lt.FLOAT16 is not None and t == Type.FIXED_LEN_BYTE_ARRAY and leaf.type_length == 2:
            return "halffloat"
        return None
    if ct is None:
        return None
    if ct == ConvertedType.DECIMAL:
        return _decimal_tag(leaf, leaf.element.precision, leaf.element.scale)
    if (ct, t) in _CONVERTED_TAGS:
        return _CONVERTED_TAGS[(ct, t)]
    if ct in _CONVERTED_INTS:
        return _INT_TAGS[_CONVERTED_INTS[ct]]
    return None


def arrow_type_tag(leaf) -> str:
    """The arrow type the reference's to_arrow gives a leaf, as str() of the
    pyarrow type names it (core/arrow_nested._logical_target over the
    storage type): the type tags of the host engine's partials."""
    if leaf.type == Type.INT96:
        return "timestamp[ns]"
    tag = _logical_tag(leaf)
    if tag is not None:
        return tag
    if leaf.type == Type.BYTE_ARRAY:
        return "large_string" if leaf.is_string() else "large_binary"
    if leaf.type == Type.FIXED_LEN_BYTE_ARRAY:
        return f"fixed_size_binary[{leaf.type_length}]"
    return _STORAGE_TAGS[leaf.type]


def _node_tag(node) -> str:
    """A tag for a column that is not a flat leaf, for the refusals."""
    return "large_list" if node.is_leaf or list_like(node) else "struct"


def _kind(tag: str) -> str:
    """The value domain of a tag: int, uint, bool, float, half, decimal,
    bytes (string / binary), fixed (fixed_size_binary), or temporal."""
    if tag in ("int8", "int16", "int32", "int64"):
        return "int"
    if tag in ("uint8", "uint16", "uint32", "uint64"):
        return "uint"
    if tag in ("float", "double"):
        return "float"
    if tag.startswith("decimal128"):
        return "decimal"
    if tag in ("large_string", "large_binary", "string"):
        return "bytes"
    if tag.startswith("fixed_size_binary"):
        return "fixed"
    if tag in ("bool", "halffloat"):
        return {"bool": "bool", "halffloat": "half"}[tag]
    return "temporal"


def _scale(tag: str) -> int:
    return int(tag[tag.index(",") + 1: -1])


_SUM_TAGS = {"int": "int64", "uint": "uint64", "bool": "uint64", "float": "double"}


def _sum_tag(tag: str):
    """The tag of a sum over `tag`, None where pyarrow has no sum kernel."""
    k = _kind(tag)
    if k == "decimal":
        return f"decimal128(38, {_scale(tag)})"
    return _SUM_TAGS.get(k)


def _no_kernel(func: str, tag: str) -> str:
    return f"Function '{func}' has no kernel matching input types ({tag})"


# -- the host engine: values ----------------------------------------------------------

_EPOCH = datetime.datetime(1970, 1, 1)
_EPOCH_UTC = datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)
_TIME_US = {"time32[ms]": 1000, "time64[us]": 1, "time64[ns]": None}
_TS_US = {"ms": 1000, "us": 1}


def _to_py(tag: str, x):
    """One physical value of a column (a Python int, float, bool or bytes)
    as the reference's as_py() gives it for `tag`."""
    k = _kind(tag)
    if k in ("int", "uint"):
        return int(x)
    if k == "bool":
        return bool(x)
    if k in ("float", "half"):
        return float(x)
    if k == "decimal":
        u = int(x)
        digits = tuple(int(c) for c in str(abs(u)))
        return decimal.Decimal((1 if u < 0 else 0, digits, -_scale(tag)))
    if k == "bytes":
        return bytes(x).decode("utf-8") if tag == "large_string" else bytes(x)
    if k == "fixed":
        return bytes(x)
    x = int(x)
    if tag == "date32[day]":
        return datetime.date(1970, 1, 1) + datetime.timedelta(days=x)
    if tag in _TIME_US:
        per = _TIME_US[tag]
        us = x // 1000 if per is None else x * per  # ns truncate to us, as with pandas
        return (_EPOCH + datetime.timedelta(microseconds=us)).time()
    unit = tag[10:12]
    utc = "tz=UTC" in tag
    if unit == "ns":
        return NanoTimestamp(x, utc)
    return (_EPOCH_UTC if utc else _EPOCH) + datetime.timedelta(microseconds=x * _TS_US[unit])


def _fixed_bytes(rows) -> ByteArrayData:
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    w = rows.shape[1] if rows.ndim == 2 else 0
    return ByteArrayData(
        offsets=np.arange(len(rows) + 1, dtype=np.int64) * w, data=rows.tobytes()
    )


def _dense(col, tag):
    """The column's dense values in the domain of its tag: int64 (int,
    temporal, decimal up to 8 bytes), uint64, bool, float32/float64/float16
    arrays, a list of Python ints (wider decimals) or ByteArrayData."""
    v, leaf = col.values, col.node
    k = _kind(tag)
    if k == "bytes":
        return v
    if k == "fixed":
        return _fixed_bytes(v)
    if k == "half":
        return np.ascontiguousarray(v, dtype=np.uint8).view("<f2").reshape(-1)
    if k == "float":
        return np.asarray(v)
    if k == "bool":
        return np.asarray(v, dtype=bool)
    if leaf.type == Type.INT96:
        m = np.ascontiguousarray(v, dtype=np.uint8).reshape(-1, 12)
        nanos = np.ascontiguousarray(m[:, :8]).view("<u8").reshape(-1)
        days = np.ascontiguousarray(m[:, 8:12]).view("<u4").reshape(-1)
        return (days.astype(np.int64) - 2440588) * 86_400_000_000_000 + nanos.astype(np.int64)
    if leaf.type == Type.FIXED_LEN_BYTE_ARRAY:  # a decimal: big-endian two's complement
        w = leaf.type_length or 0
        m = np.ascontiguousarray(v, dtype=np.uint8).reshape(-1, w)
        if w <= 8:
            pad = np.where(m[:, :1] >= 0x80, 0xFF, 0).astype(np.uint8)
            full = np.concatenate([np.repeat(pad, 8 - w, axis=1), m], axis=1)
            return np.ascontiguousarray(full).view(">i8").reshape(-1).astype(np.int64)
        return [int.from_bytes(r.tobytes(), "big", signed=True) for r in m]
    a = np.asarray(v)
    if k == "uint":
        return a.view(np.uint32 if a.dtype == np.int32 else np.uint64).astype(np.uint64)
    return a.astype(np.int64)


def _bytes_at(b: ByteArrayData, i: int) -> bytes:
    return bytes(b.data[int(b.offsets[i]): int(b.offsets[i + 1])])


def _item(d, i: int):
    return _bytes_at(d, i) if isinstance(d, ByteArrayData) else d[i]


# -- the host engine: float sums and min / max ---------------------------------------

_BLOCK = 16


def _arrow_float_sum(values, valid=None):
    """Arrow's sum of one float chunk (its SumArray), bit for bit: the valid
    values, widened to double one by one, are summed in blocks of 16, each
    block sequentially from 0.0, the blocks restarting at every run of valid
    values; the block sums combine in a binary-counter tree (a pair of equal
    levels adds, the earlier on the left), and the levels left at the end add
    from the lowest up. `values` are the dense valid values, `valid` the
    chunk's bool validity (None: no nulls). None when nothing is valid."""
    vals = np.asarray(values, dtype=np.float64)
    n = len(vals)
    if n == 0:
        return None
    with np.errstate(all="ignore"):  # inf - inf is NaN, as in Arrow
        return _pairwise(vals, n, valid)


def _pairwise(vals, n, valid):
    if valid is None:
        runs = np.array([n], dtype=np.int64)
    else:
        v = np.asarray(valid, dtype=np.int8)
        edges = np.flatnonzero(np.diff(np.concatenate(([0], v, [0]))))
        runs = edges[1::2] - edges[0::2]
    # blocks: each run split into 16s and a remainder, in dense positions
    nblk = -(-runs // _BLOCK)
    run_start = np.concatenate(([0], np.cumsum(runs)[:-1]))
    first_blk = np.concatenate(([0], np.cumsum(nblk)[:-1]))
    blk_run = np.repeat(np.arange(len(runs)), nblk)
    k = np.arange(int(nblk.sum())) - first_blk[blk_run]
    starts = run_start[blk_run] + k * _BLOCK
    lens = np.minimum(_BLOCK, runs[blk_run] - k * _BLOCK)
    # each block's sum from 0.0 in order: column j adds the j-th value of
    # every block at once (a short block adds +0.0, which changes no sum
    # that does not start at -0.0, and none does)
    idx = starts[:, None] + np.arange(_BLOCK)
    mat = np.where(np.arange(_BLOCK) < lens[:, None], vals[np.minimum(idx, n - 1)], 0.0)
    acc = np.zeros(len(starts))
    for j in range(_BLOCK):
        acc = acc + mat[:, j]
    # the counter tree: with m blocks, bit b of m set holds a perfect tree
    # of 2^b blocks (levels[b][i] sums blocks [i*2^b, (i+1)*2^b))
    levels = [acc]
    while len(levels[-1]) >= 2:
        a = levels[-1]
        h = len(a) // 2 * 2
        levels.append(a[0:h:2] + a[1:h:2])
    m = len(acc)
    nodes = []
    pos = 0
    for b in range(m.bit_length() - 1, -1, -1):
        if m >> b & 1:
            nodes.append(levels[b][pos >> b])
            pos += 1 << b
    total = nodes[-1]
    for x in reversed(nodes[:-1]):
        total = x + total
    return float(0.0 + total)


# Arrow's scalar min/max keep the first of two equal values, but its
# null-aware pass over a chunk with nulls breaks a tie between -0.0 and 0.0
# in 64-row words as pyarrow's compiled kernels do: (rule for a word with
# every row valid, rule for a word with some), "last" keeping the later of
# two equal values. Held against pyarrow by the tests.
_ZERO_TIES = {
    ("float", "min"): ("last", "first"), ("float", "max"): ("first", "first"),
    ("double", "min"): ("first", "first"), ("double", "max"): ("last", "last"),
}


def _float_extreme(values, valid, op, tag):
    """Global min/max of one float chunk: NaN skipped unless every value is
    NaN, ties of -0.0 and 0.0 as _ZERO_TIES. None over no valid values."""
    if len(values) == 0:
        return None
    vals = np.asarray(values)
    if np.isnan(vals).all():
        return float("nan")
    m = float(np.nanmin(vals) if op == "min" else np.nanmax(vals))
    if m != 0.0:
        return m
    zeros = np.flatnonzero(vals == 0)
    if valid is None or valid.all():  # Arrow's null-aware pass runs only over nulls
        win = zeros[0]
    else:
        rows = np.flatnonzero(valid)[zeros]
        words = rows // 64
        n = len(valid)
        full_rule, mixed_rule = _ZERO_TIES[(tag, op)]
        win = None
        for w in np.unique(words):
            lo, hi = w * 64, min(w * 64 + 64, n)
            rule = full_rule if valid[lo:hi].all() else mixed_rule
            in_w = zeros[words == w]
            if rule == "last":
                win = in_w[-1]
            elif win is None:
                win = in_w[0]
    return float(vals[win])


def _global_extreme(dense, valid, op, tag):
    k = _kind(tag)
    if len(dense) == 0:
        return None
    if k == "float":
        return _float_extreme(dense, valid, op, tag)
    if k in ("bytes", "fixed"):
        lo, hi = get_native().bytes_minmax(dense.data, dense.offsets)
        return _to_py(tag, _bytes_at(dense, int(lo if op == "min" else hi)))
    if isinstance(dense, list):
        return _to_py(tag, min(dense) if op == "min" else max(dense))
    return _to_py(tag, dense.min() if op == "min" else dense.max())


def _global_sum(dense, tag):
    k = _kind(tag)
    if len(dense) == 0:
        return None
    if k == "int":
        return int(dense.sum(dtype=np.int64))
    if k == "uint":
        return int(dense.sum(dtype=np.uint64))
    if k == "bool":
        return int(np.count_nonzero(dense))
    return _to_py(f"decimal128(38, {_scale(tag)})", _wrap128(_exact_sum(dense)))


def _exact_sum(dense) -> int:
    """The exact sum of int64 values (or Python ints): the high and low
    32-bit halves sum without overflow below 2^31 values."""
    if isinstance(dense, list):
        return sum(dense)
    return (int((dense >> 32).sum()) << 32) + int((dense & 0xFFFFFFFF).sum())


def _wrap128(u: int) -> int:
    u &= (1 << 128) - 1
    return u - (1 << 128) if u >> 127 else u


# -- the host engine: group-by --------------------------------------------------------


def _overflow(query) -> ServeError:
    return ServeError(
        413, "group_overflow",
        f"group-by cardinality exceeded max_groups={query.max_groups}; narrow "
        "the filter or raise max_groups",
    )


_NAN64 = np.float64(np.nan).view(np.uint64)
_NAN32 = np.float32(np.nan).view(np.uint32)


def _key_bits(dense, tag):
    """Bit patterns that factorize a key column by value: floats by their
    bits with every NaN one pattern (-0.0 apart from 0.0)."""
    k = _kind(tag)
    if k == "float" and dense.dtype == np.float32:
        b = dense.view(np.uint32).copy()
        b[np.isnan(dense)] = _NAN32
        return b
    if k in ("float", "half"):
        d = dense.astype(np.float64) if k == "half" else dense
        b = d.view(np.uint64).copy()
        b[np.isnan(d)] = _NAN64
        return b
    if k == "bool":
        return dense.astype(np.uint64)
    return np.asarray(dense).view(np.uint64) if dense.dtype == np.int64 else dense


def _first_occurrence(bits, cap, query):
    """(firsts, codes) of the first-occurrence dictionary of uint64 bits,
    its entries capped at `cap` (413 past it)."""
    if len(bits) == 0:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
    out = get_native().u64_dict_indices(np.ascontiguousarray(bits, dtype=np.uint64), cap)
    if out is None:
        raise _overflow(query)
    firsts, codes = out
    return firsts.astype(np.int64), codes.astype(np.int64)


def _factorize_key(col, tag, query):
    """(row codes int64[rows], Python key per code) of one key column: its
    distinct values in first-occurrence order, null one code of its own."""
    dense = _dense(col, tag)
    cap = query.max_groups
    if isinstance(dense, ByteArrayData):
        out = get_native().bytes_dict_indices(dense.data, dense.offsets, cap) if len(dense) else (
            np.zeros(0, np.uint32), np.zeros(0, np.uint32))
        if out is None:
            raise _overflow(query)
        firsts, codes = out[0].astype(np.int64), out[1].astype(np.int64)
    elif isinstance(dense, list):  # decimals wider than 8 bytes
        seen: dict = {}
        codes = np.array([seen.setdefault(x, len(seen)) for x in dense], dtype=np.int64)
        if len(seen) > cap:
            raise _overflow(query)
        firsts = np.zeros(len(seen), dtype=np.int64)
        firsts[codes[::-1]] = np.arange(len(codes))[::-1]
    else:
        firsts, codes = _first_occurrence(_key_bits(dense, tag), cap, query)
    values = [_to_py(tag, _item(dense, int(i))) for i in firsts]
    if col.valid is None:
        return codes, values
    rows = np.full(col.num_rows, len(values), dtype=np.int64)
    rows[col.valid] = codes
    return rows, values + [None]


def _group_codes(cols, tags, query):
    """(group of each row, key tuple per group): groups in order of first
    occurrence, as pyarrow's hash group-by numbers them."""
    per_key, keyvals = [], []
    combined = None
    for col, tag in zip(cols, tags):
        codes, values = _factorize_key(col, tag, query)
        per_key.append(codes)
        keyvals.append(values)
        if combined is None:
            combined = codes
        else:
            _f, combined = _first_occurrence(
                combined.astype(np.uint64) * np.uint64(len(values)) + codes.astype(np.uint64),
                query.max_groups, query,
            )
    firsts, g = _first_occurrence(combined.astype(np.uint64), query.max_groups, query)
    keys = [tuple(vals[int(ck[i])] for ck, vals in zip(per_key, keyvals)) for i in firsts]
    return g, keys


def _byte_list(b: ByteArrayData) -> list:
    data = b.data if isinstance(b.data, bytes) else bytes(b.data)
    return ByteArrayData(offsets=b.offsets, data=data).to_list()


def _byte_ranks(dense, cache, key):
    """(distinct values, their order by bytes, each row's rank) of a byte
    column, computed once a column (`cache`)."""
    if cache is not None and key in cache:
        return cache[key]
    if len(dense):
        firsts, codes = get_native().bytes_dict_indices(dense.data, dense.offsets, len(dense))
    else:
        firsts, codes = np.zeros(0, np.uint32), np.zeros(0, np.uint32)
    uniq = _byte_list(dense.take(firsts.astype(np.int64)))
    order = sorted(range(len(uniq)), key=uniq.__getitem__)
    rank = np.empty(len(uniq), dtype=np.int64)
    rank[order] = np.arange(len(uniq))
    out = (uniq, order, rank[codes.astype(np.int64)])
    if cache is not None:
        cache[key] = out
    return out


def _grouped_agg(op, col, tag, g, ngroups, cache=None):
    """One aggregate per group (the reference's hash_count / hash_sum /
    hash_min / hash_max): sums of floats in row order from 0.0, of integers
    wrapped in 64 bits, min/max skipping NaN with the first of -0.0 and 0.0
    kept; None for a group with no valid value."""
    gv = g if col.valid is None else g[col.valid]
    counts = np.bincount(gv, minlength=ngroups)
    if op == "count":
        return [int(c) for c in counts]
    dense = _dense(col, tag)
    k = _kind(tag)
    if op == "sum":
        if k == "float":
            with np.errstate(all="ignore"):
                out = np.bincount(gv, weights=dense.astype(np.float64), minlength=ngroups)
            out = out.tolist()
        elif k == "bool":
            out = np.bincount(gv[dense], minlength=ngroups).tolist()
        elif k in ("int", "uint"):
            acc = np.zeros(ngroups, dtype=dense.dtype)
            np.add.at(acc, gv, dense)
            out = acc.tolist()
        else:  # decimal: exact, wrapped to 128 bits, at the column's scale
            if isinstance(dense, list):
                acc = [0] * ngroups
                for gi, x in zip(gv.tolist(), dense):
                    acc[gi] += x
            else:
                hi = np.zeros(ngroups, dtype=np.int64)
                lo = np.zeros(ngroups, dtype=np.int64)
                np.add.at(hi, gv, dense >> 32)
                np.add.at(lo, gv, dense & 0xFFFFFFFF)
                acc = [(h << 32) + low for h, low in zip(hi.tolist(), lo.tolist())]
            stag = f"decimal128(38, {_scale(tag)})"
            out = [_to_py(stag, _wrap128(x)) for x in acc]
        return [x if c else None for x, c in zip(out, counts)]
    if k in ("bytes", "fixed"):
        uniq, order, r = _byte_ranks(dense, cache, id(col))
        ufunc = np.minimum if op == "min" else np.maximum
        acc = np.full(ngroups, len(uniq) if op == "min" else -1, dtype=np.int64)
        ufunc.at(acc, gv, r)
        return [_to_py(tag, uniq[order[x]]) if c else None for x, c in zip(acc.tolist(), counts)]
    if isinstance(dense, list):  # decimals wider than 8 bytes
        acc = [None] * ngroups
        pick = min if op == "min" else max
        for gi, x in zip(gv.tolist(), dense):
            acc[gi] = x if acc[gi] is None else pick(acc[gi], x)
        return [None if x is None else _to_py(tag, x) for x in acc]
    if k in ("float",):
        acc = np.full(ngroups, np.nan, dtype=dense.dtype)
        (np.fmin if op == "min" else np.fmax).at(acc, gv, dense)
        # a zero extreme takes the sign of the group's first zero
        z = np.flatnonzero(dense == 0)
        if len(z):
            zg, first = np.unique(gv[z], return_index=True)
            zero_groups = zg[acc[zg] == 0]
            sign = dict(zip(zg.tolist(), np.signbit(dense[z[first]]).tolist()))
            for gi in zero_groups.tolist():
                acc[gi] = -0.0 if sign[gi] else 0.0
        return [_to_py(tag, x) if c else None for x, c in zip(acc.tolist(), counts)]
    info = np.iinfo(dense.dtype) if dense.dtype != bool else None
    if info is None:
        acc = np.full(ngroups, op == "min", dtype=bool)
        (np.logical_and if op == "min" else np.logical_or).at(acc, gv, dense)
    else:
        acc = np.full(ngroups, info.max if op == "min" else info.min, dtype=dense.dtype)
        (np.minimum if op == "min" else np.maximum).at(acc, gv, dense)
    return [_to_py(tag, x) if c else None for x, c in zip(acc.tolist(), counts)]


# -- the host engine: one unit --------------------------------------------------------


def _agg_column(table, name: str):
    """The unit table's column for a dotted aggregate name (struct fields
    through their parents, as pc.struct_field reaches them)."""
    parts = tuple(name.split("."))
    try:
        col = table.column(parts[:1])
    except KeyError:
        raise ServeError(400, "bad_aggregates", f"aggregate column {name!r} not in scan") from None
    for k in range(1, len(parts)):
        node = col.node
        if node.is_leaf or list_like(node):
            # pyarrow's struct_field over a list: a raw error the daemon
            # answers as an internal one
            raise ServeError(
                500, "internal",
                "ArrowNotImplementedError: " + _no_kernel("struct_field", _node_tag(node)),
            )
        col = table.column(parts[: k + 1])
    return col


def _leaf_tag(col):
    """The column's arrow tag, or None for a node that is not a flat leaf."""
    node = col.node
    return arrow_type_tag(node) if col.values is not None or (
        node.is_leaf and node.max_rep == 0) else None


def _check_op(op, col, tag, name, grouped):
    """The refusal pyarrow gives an aggregate it has no kernel for, or the
    result's tag."""
    func = "sum" if op == "sum" else "min_max"
    typ = tag if tag is not None else _node_tag(col.node)
    if op == "sum":
        out = None if tag is None else _sum_tag(tag)
    else:
        out = None if tag is None or tag == "halffloat" else tag
    if out is None:
        detail = _no_kernel(f"hash_{op}" if grouped else func, typ)
        if grouped:
            raise ServeError(400, "bad_aggregates", f"cannot group by {list(grouped)}: {detail}")
        raise ServeError(400, "bad_aggregates", f"cannot {op} column {name!r}: {detail}")
    return out


def unit_partial(table, query: QueryRequest):
    """(groups, types) partial of one unit's table (core/unit_table.
    HostUnitTable, FileReader._host_unit_table): groups maps a key tuple to
    one Python value per aggregate (the global form uses the () key), as
    the reference's pyarrow kernels compute them; types carries each
    aggregate's arrow type tag (arrow_type_tag's names) so merges run in
    the same domain. The reference's refusals are its typed 400
    bad_aggregates."""
    aggs = query.aggregates
    if not query.group_by:
        vals: list = []
        types: list = [None] * len(aggs)
        for j, a in enumerate(aggs):
            if a.column is None:
                vals.append(table.num_rows)
                continue
            col = _agg_column(table, a.column)
            if a.op == "count":
                vals.append(col.num_rows - col.null_count)
                continue
            tag = _leaf_tag(col)
            types[j] = _check_op(a.op, col, tag, a.column, None)
            dense = _dense(col, tag)
            if a.op == "sum":
                if _kind(tag) == "float":
                    vals.append(_arrow_float_sum(dense, col.valid))
                else:
                    vals.append(_global_sum(dense, tag))
            else:
                vals.append(_global_extreme(dense, col.valid, a.op, tag))
        return {(): vals}, types
    keys = list(query.group_by)

    def top(name):
        # the grouped kernels take top-level columns by name only
        if "." in name or name not in table.tops:
            raise ServeError(
                400, "bad_aggregates",
                f"cannot group by {keys}: No match for FieldRef.Name({name})",
            )
        return table.column((name,))

    key_cols, key_tags = [], []
    for k in keys:
        col = top(k)
        tag = _leaf_tag(col)
        if tag is None:
            raise ServeError(
                400, "bad_aggregates",
                f"cannot group by {keys}: Keys of type {_node_tag(col.node)}",
            )
        key_cols.append(col)
        key_tags.append(tag)
    plans = []
    types: list = [None] * len(aggs)
    for j, a in enumerate(aggs):
        if a.column is None:
            plans.append(("count_all", None, None))
            continue
        col = top(a.column)
        tag = _leaf_tag(col)
        if a.op != "count":
            types[j] = _check_op(a.op, col, tag, a.column, keys)
        plans.append((a.op, col, tag))
    g, key_tuples = _group_codes(key_cols, key_tags, query)
    ng = len(key_tuples)
    columns = []
    cache: dict = {}  # a byte column's ranks, shared by its min and max
    for op, col, tag in plans:
        if op == "count_all":
            columns.append(np.bincount(g, minlength=ng).tolist())
        else:
            columns.append(_grouped_agg(op, col, tag, g, ng, cache))
    groups = {}
    for gi, key in enumerate(key_tuples):
        groups[key] = [c[gi] for c in columns]
    return groups, types


def _infer_tag(a, b) -> str:
    """The type pyarrow infers for the pair [a, b] of untyped partials."""
    if isinstance(a, bool) and isinstance(b, bool):
        return "bool"
    if not isinstance(a, bool) and not isinstance(b, bool):
        if isinstance(a, int) and isinstance(b, int):
            return "int64"
        if isinstance(a, (int, float)) and isinstance(b, (int, float)):
            return "double"
        if isinstance(a, str) and isinstance(b, str):
            return "string"
        if isinstance(a, (str, decimal.Decimal)) and isinstance(b, (str, decimal.Decimal)):
            return "string"  # a DECIMAL sum's string after a merge made it a Decimal
    raise ServeError(500, "internal", f"cannot merge partials {a!r} and {b!r}")


def _decimal_sum(a, b, scale=None):
    """a + b of two decimals (Decimal or their str()) as pyarrow's decimal128
    sum gives it: exact at the scale (`scale`, or the finer of the two),
    wrapped to 128 bits."""
    a, b = decimal.Decimal(a), decimal.Decimal(b)
    if scale is None:
        scale = max(0, -a.as_tuple().exponent, -b.as_tuple().exponent)
    unit = decimal.Decimal((0, (1,), -scale))
    with decimal.localcontext(decimal.Context(prec=200)):
        u = int(a / unit) + int(b / unit)
    return _to_py(f"decimal128(38, {scale})", _wrap128(u))


def _merge_value(op: str, a, b, typ):
    """Merge two partial values of one aggregate as the reference's pyarrow
    kernel does over [a, b] of type `typ` (a type tag): counts add; None (no
    matching rows) passes the other through; sums wrap in 64 bits in the
    int64 or uint64 domain, add doubles from 0.0, add decimals exactly at
    their scale; min and max skip NaN and keep the first of two equal
    values. An untyped pair (typ None: the mesh router's partials, parsed
    from replica bodies) takes the type pyarrow infers for it: int64, double
    for floats or a mix of ints and floats, bool, or string (compared by its
    UTF-8 bytes). Two strings summed are decimals (a DECIMAL sum travels as
    its str()): the reference answers that pair with a 500, the port with
    the decimal sum one daemon answers (ROADMAP section 3)."""
    if op == "count":
        return int(a) + int(b)
    if a is None:
        return b
    if b is None:
        return a
    if typ is None:
        typ = _infer_tag(a, b)
    k = _kind(typ)
    if op == "sum":
        if typ in ("int64", "uint64"):
            s = (int(a) + int(b)) & _M64
            return s - (1 << 64) if typ == "int64" and s >> 63 else s
        if k == "float":
            return (0.0 + float(a)) + float(b)
        if k == "bool":
            return int(a) + int(b)
        if k == "decimal" or typ == "string":
            try:
                return _decimal_sum(a, b, _scale(typ) if k == "decimal" else None)
            except (decimal.InvalidOperation, ValueError, TypeError):
                pass
        raise ServeError(500, "internal", f"sum partials of type {typ!r}")
    if k == "float":
        a, b = float(a), float(b)
        if math.isnan(a):
            return b
        if math.isnan(b):
            return a
    return b if (b < a if op == "min" else b > a) else a


class QueryState:
    """The merged aggregate state one request accumulates unit by unit."""

    __slots__ = ("query", "groups", "types", "rows_scanned", "rows_matched")

    def __init__(self, query: QueryRequest):
        self.query = query
        self.types: list = [None] * len(query.aggregates)
        self.rows_scanned = 0
        self.rows_matched = 0
        if query.group_by:
            self.groups: dict = {}
        else:
            # the global row exists even over zero units: count 0, sum/min/
            # max null — matching pyarrow kernels over an empty column
            self.groups = {
                (): [0 if a.column is None or a.op == "count" else None
                     for a in query.aggregates]
            }

    def absorb(self, part) -> None:
        """Merge one unit's ((groups, types), scanned, matched) partial."""
        (groups, types), scanned, matched = part
        self.rows_scanned += scanned
        self.rows_matched += matched
        for j, t in enumerate(types):
            if self.types[j] is None:
                self.types[j] = t
        q = self.query
        for key, vals in groups.items():
            cur = self.groups.get(key)
            if cur is None:
                if len(self.groups) >= q.max_groups:
                    raise _overflow(q)
                self.groups[key] = list(vals)
                continue
            for j, a in enumerate(q.aggregates):
                op = "count" if a.column is None else a.op
                cur[j] = _merge_value(op, cur[j], vals[j], self.types[j])


def _key_order(key: tuple) -> str:
    # deterministic total order over arbitrary (possibly None/mixed) keys:
    # their canonical JSON encoding — the same bytes the body renders
    return json.dumps(list(key), default=json_default)


def result_dict(query: QueryRequest, state: QueryState, *, units: int) -> dict:
    """The response body, deterministically ordered (groups sort by their
    canonical key encoding) so daemon bytes == CLI bytes."""
    names = [agg_name(a) for a in query.aggregates]
    body: dict = {
        "group_by": list(query.group_by),
        "aggregates": names,
        "units": units,
        "rows_scanned": state.rows_scanned,
        "rows_matched": state.rows_matched,
    }
    if query.group_by:
        body["group_count"] = len(state.groups)
        body["groups"] = [
            {
                "key": list(key),
                "aggregates": dict(zip(names, state.groups[key])),
            }
            for key in sorted(state.groups, key=_key_order)
        ]
    else:
        body["result"] = dict(zip(names, state.groups[()]))
    return body


def render_query_body(body: dict) -> bytes:
    """ONE canonical serialization (shared with `parquet-tool scan
    --aggregate`), so a daemon response is byte-identical to the CLI's."""
    return (json.dumps(body, default=json_default) + "\n").encode()


def host_unit_partial(reader, row_group: int, query: QueryRequest, filters):
    """One unit's ((groups, types), scanned, matched) partial on the host
    engine: the unit table (FileReader._host_unit_table over
    query_columns) through unit_partial. A filter the host mask declines
    is a typed 501 (the reference evaluates it with pyarrow compute)."""
    try:
        table = reader._host_unit_table(row_group, query_columns(query), filters)
    except VecFilterError as e:
        raise filter_not_ported(e) from None
    n = int(reader.row_group(row_group).num_rows or 0)
    return unit_partial(table, query), n, table.num_rows


def run_unit(reader, row_group: int, query: QueryRequest, filters):
    """The reference's engine ladder for one unit: the device first, and
    the host engine for a unit the device declines, each counted."""
    try:
        part = device_unit_partial(reader, row_group, query, filters)
    except DeviceQueryError:
        _bump("host_fallback")
        return host_unit_partial(reader, row_group, query, filters)
    _bump("device")
    return part


def run_local_query(paths, query: QueryRequest, *, device=None) -> dict:
    """The daemon-free twin of POST /v1/query over local files: plan the
    units (data/plan.build_plan: row groups admitted by statistics and
    bloom filters, files in sorted order), take this shard's stripe of them
    when `query.shard` is (index, count) (epoch 0's unshuffled order, as
    the reference stripes it), run each on the engine ladder (run_unit: the
    device, `device`, default CUDA, then the host engine), merge. A
    count(*)-only query without filters reads footers only."""
    from ..core.reader import FileReader, resolve_device
    from ..data.plan import build_plan, expand_paths

    device = resolve_device(device)  # no CUDA and no device=: raise, even for footers only
    files: list = []
    for p in paths:
        files.extend(expand_paths(p))
    files = sorted(set(files))
    plan = build_plan(files, filters=query.filters)
    if query.shard is not None:
        order = plan.epoch_order(0, shard_index=query.shard[0], shard_count=query.shard[1])
        units = [plan.units[k] for k in order]
    else:
        units = list(plan.units)
    cols = query_columns(query)
    decode = bool(cols) or query.filters is not None
    state = QueryState(query)
    # one reader per file, opened at its first unit and kept for the rest
    # (footer and schema parsed once), units absorbed in plan order
    readers: dict = {}
    with ExitStack() as stack:
        for u in units:
            if not decode:
                state.absorb((unit_count_partial(query, u.num_rows), u.num_rows, u.num_rows))
                continue
            r = readers.get(u.file_index)
            if r is None:
                r = readers[u.file_index] = stack.enter_context(
                    FileReader(u.path, device=device, metadata=plan.metas[u.file_index])
                )
            state.absorb(run_unit(r, u.row_group, query, query.filters))
    return result_dict(query, state, units=len(units))
