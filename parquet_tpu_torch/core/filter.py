"""Statistics-based row-group pruning: filter normalization and the
min/max/null-count proof that a row group holds no match.

A copy of parquet_tpu/core/filter.py cut to what the port's filtering
uses: `normalize_filters` / `normalize_dnf` (with their coercion helpers),
the statistics decode, `row_group_may_match` / `dnf_group_may_match`, and
the page-index pruning (`page_ranges_matching`, `dnf_page_ranges`: the row
ranges of a group whose pages the ColumnIndex cannot rule out), and the
scalar row walk (`row_matches` / `dnf_row_matches`) that FileReader.iter_rows
falls back to where the vectorized mask (core/filter_vec) declines.

Filters are pyarrow-style conjunctive triples, or an OR of conjunctions:

    FileReader(path).iter_device_batches(
        100_000, filters=[("ts", ">=", t0), ("vendor", "==", "v1")], filter_rows=True)

Pruning is CONSERVATIVE: a row group is skipped only when its written
min/max/null-count statistics prove no row can match. Surviving groups are
decoded and, with filter_rows=True (or through iter_rows(filters=)),
checked row by row, so the result is exact regardless of how coarse (or
absent) the statistics are.
"""

from __future__ import annotations

import datetime as dt
import decimal
import math
import struct

from ..meta.parquet_types import Type
from .assembly import logical_kind
from .schema import Schema
from .stats import _PACK, column_is_unsigned

__all__ = [
    "FilterError",
    "normalize_filters",
    "normalize_dnf",
    "row_group_may_match",
    "dnf_group_may_match",
    "dnf_page_ranges",
    "dnf_row_matches",
    "page_ranges_matching",
    "row_matches",
]

_OPS = (
    "==", "!=", "<", "<=", ">", ">=", "is_null", "not_null", "in", "not_in",
    "contains",
)

_EPOCH_DATE = dt.date(1970, 1, 1)
_EPOCH_UTC = dt.datetime(1970, 1, 1, tzinfo=dt.timezone.utc)

_UNSIGNED = {
    Type.INT32: struct.Struct("<I"),
    Type.INT64: struct.Struct("<Q"),
}


class FilterError(ValueError):
    pass


def _is_unsigned(leaf) -> bool:
    # one shared definition of UNSIGNED order (stats.py writes with it,
    # this module decodes with it — they must never drift)
    return column_is_unsigned(leaf)


def normalize_filters(schema: Schema, filters) -> list:
    """Validate and resolve [(column, op, value)] against flat leaf columns.

    Each entry carries the value in TWO domains: `row_value` for exact
    per-row comparison (the ergonomic domain iter_rows yields — datetime,
    date, Decimal, str) and a `(stat_lo, stat_hi)` bracket for statistics
    pruning (the physical storage domain), or (None, None) when this
    column's statistics cannot be ordered safely (INT96, binary-backed
    DECIMAL, legacy binary min/max). The bracket satisfies
    stat_lo <= value <= stat_hi with both ends representable physically, so
    an inexact coercion (fractional decimal beyond the column's scale, a
    sub-unit timestamp) straddles the value and pruning stays conservative
    in BOTH comparison directions; stat_lo != stat_hi means no stored value
    can equal the filter value exactly.
    """
    out = []
    for f in filters:
        if len(f) == 2:
            name, op = f
            value = None
        else:
            name, op, value = f
        if op not in _OPS:
            raise FilterError(f"filter: unknown op {op!r} (use one of {_OPS})")
        path = tuple(name.split(".")) if isinstance(name, str) else tuple(name)
        try:
            leaf = schema.column(path)
        except Exception as e:
            raise FilterError(f"filter: unknown column {name!r}") from e
        if op == "contains":
            # list membership: the named field must resolve (through an
            # annotated LIST wrapper, or directly for a legacy repeated
            # leaf) to ONE single-level repeated element leaf. The row
            # domain is the top-level field (rows hold the unwrapped list),
            # so only top-level names are addressable.
            if len(path) != 1:
                raise FilterError(
                    f"filter: contains on {name!r}: only top-level LIST "
                    "columns can be tested for membership"
                )
            leaf = _contains_leaf(name, leaf)
            row_value, stat_lo, stat_hi = _coerce_value(leaf, value)
            out.append((leaf.path, leaf, op, row_value, stat_lo, stat_hi))
            continue
        if not leaf.is_leaf or leaf.max_rep > 0:
            raise FilterError(
                f"filter: {name!r} is not a flat leaf column (repeated/nested "
                "columns cannot be pruned by chunk statistics; use "
                "'contains' for LIST membership)"
            )
        if op in ("is_null", "not_null"):
            if value is not None:
                raise FilterError(f"filter: {op} takes no value")
            out.append((path, leaf, op, None, None, None))
            continue
        if op in ("in", "not_in"):
            # row_value = members in ONE shared row domain (set when
            # hashable, for O(1) membership); vlo = list of (stat_lo,
            # stat_hi) brackets (None when any element's stats are
            # un-orderable — pruning then declines); vhi unused
            if not isinstance(value, (list, tuple, set, frozenset)):
                raise FilterError(f"filter: {op} takes a list/tuple/set of values")
            rows, brackets = [], []
            for v in value:
                rv, lo, hi = _coerce_value(leaf, v)
                rows.append(rv)
                brackets.append((lo, hi))
            if any(lo is None for lo, _ in brackets):
                brackets = None
            rows = _unify_members(rows)
            try:
                members = frozenset(rows)
            except TypeError:
                members = rows  # unhashable member type: linear scan
            out.append((path, leaf, op, members, brackets, None))
            continue
        row_value, stat_lo, stat_hi = _coerce_value(leaf, value)
        out.append((path, leaf, op, row_value, stat_lo, stat_hi))
    return out


def _contains_leaf(name, node):
    """Resolve a top-level field to its single LIST element leaf for a
    'contains' predicate: a legacy repeated leaf IS the element; an
    annotated LIST wrapper descends its single-child chain. Anything else
    (struct elements, multi-level lists, flat leaves) is refused typed."""
    while not node.is_leaf:
        if len(node.children) != 1:
            raise FilterError(
                f"filter: contains on {name!r}: list elements must be a "
                "single leaf column (struct elements cannot be compared)"
            )
        node = node.children[0]
    if node.max_rep != 1:
        raise FilterError(
            f"filter: contains on {name!r}: expected a single-level LIST "
            f"column (element repetition depth is {node.max_rep})"
        )
    return node


def _unify_members(rows: list) -> list:
    """Lift in-list members into ONE comparison domain. TIME coercion is the
    only mixed case: sub-microsecond members become Time, whole-microsecond
    members dt.time — comparing across those is order-dependent, so every
    dt.time member lifts to Time when any Time member exists."""
    from ..floor.time import Time

    if any(isinstance(r, Time) for r in rows) and any(
        isinstance(r, dt.time) and not isinstance(r, Time) for r in rows
    ):
        utc = next(r.utc for r in rows if isinstance(r, Time))
        return [
            Time.from_time(r, utc=utc)
            if isinstance(r, dt.time) and not isinstance(r, Time)
            else r
            for r in rows
        ]
    return rows


def _int_bracket(value):
    """Exact row value + integer floor/ceil bracket for an integer-backed
    physical domain. Accepts int, float, Decimal, or numeric-string values."""
    if isinstance(value, str):
        try:
            v = int(value)
        except ValueError as e:
            raise FilterError(f"filter: integer column takes a number, got {value!r}") from e
        return v, v, v
    try:
        f = math.floor(value)
        c = math.ceil(value)
    except (TypeError, ValueError, OverflowError, ArithmeticError) as e:
        # inf/nan (float or Decimal) and non-numeric values all land here
        raise FilterError(f"filter: cannot compare an integer column against {value!r}") from e
    # keep the caller's exact value for per-row comparison when inexact
    # (int vs float/Decimal compare exactly in Python)
    row = int(value) if f == c else value
    return row, f, c


def _coerce_value(leaf, value):
    """(row-domain value, physical stat floor, physical stat ceil)."""
    if value is None:
        raise FilterError("filter: comparison against None (use is_null)")
    t = leaf.type
    kind = logical_kind(leaf)
    if kind is not None:
        return _coerce_logical(leaf, kind, value)
    if t in (Type.INT32, Type.INT64):
        return _int_bracket(value)
    if t in (Type.FLOAT, Type.DOUBLE):
        v = float(value)
        return v, v, v
    if t == Type.BOOLEAN:
        v = bool(value)
        return v, v, v
    b = value.encode("utf-8") if isinstance(value, str) else bytes(value)
    return b, b, b


def _coerce_logical(leaf, kind, value):
    """Logically-typed columns: rows yield converted Python objects; stats
    store the physical encoding. Produce both."""
    if kind[0] == "uint":
        row, lo, hi = _int_bracket(value)
        if row < 0:
            raise FilterError("filter: unsigned column takes a non-negative int")
        return row, lo, hi
    if kind == "int96":
        if not isinstance(value, dt.datetime):
            raise FilterError("filter: INT96 column takes a datetime")
        if value.tzinfo is None:
            value = value.replace(tzinfo=dt.timezone.utc)
        return value, None, None  # INT96 byte stats have no usable ordering
    if kind == "decimal":
        try:
            v = decimal.Decimal(value)
        except (decimal.InvalidOperation, TypeError, ValueError) as e:
            raise FilterError(f"filter: DECIMAL column takes a number, got {value!r}") from e
        scale = leaf.element.scale or (
            leaf.logical_type.DECIMAL.scale if leaf.logical_type and leaf.logical_type.DECIMAL else 0
        )
        if leaf.type in (Type.INT32, Type.INT64):
            try:
                unscaled = v.scaleb(scale or 0)
                lo = int(unscaled.to_integral_value(rounding=decimal.ROUND_FLOOR))
                hi = int(unscaled.to_integral_value(rounding=decimal.ROUND_CEILING))
            except (decimal.InvalidOperation, OverflowError, ValueError) as e:
                # non-finite (NaN/Infinity) values have no integer bracket
                raise FilterError(f"filter: cannot compare DECIMAL column against {value!r}") from e
            return v, lo, hi
        return v, None, None  # binary-backed decimals: sign-magnitude bytes unordered
    if kind == "date":
        if isinstance(value, dt.datetime):
            value = value.date()
        if not isinstance(value, dt.date):
            raise FilterError("filter: DATE column takes a date")
        days = (value - _EPOCH_DATE).days
        return value, days, days
    if kind[0] == "timestamp":
        _, unit, utc = kind
        if not isinstance(value, dt.datetime):
            raise FilterError("filter: TIMESTAMP column takes a datetime")
        aware = value if value.tzinfo is not None else value.replace(tzinfo=dt.timezone.utc)
        micros = (aware - _EPOCH_UTC) // dt.timedelta(microseconds=1)
        lo, hi = _unit_bracket(micros, unit)
        if unit == "NANOS":
            import numpy as np

            row_value = np.datetime64(micros * 1000, "ns")  # rows yield datetime64[ns]
        else:
            row_value = aware if utc else aware.replace(tzinfo=None)
        return row_value, lo, hi
    if kind[0] == "time":
        unit = kind[1]
        from ..floor.time import Time

        if isinstance(value, Time):
            nanos = value.nanos
        elif isinstance(value, dt.time):
            nanos = (
                ((value.hour * 60 + value.minute) * 60 + value.second) * 1_000_000_000
                + value.microsecond * 1000
            )
        else:
            raise FilterError("filter: TIME column takes a time or floor.Time")
        div = {"MILLIS": 1_000_000, "MICROS": 1_000, "NANOS": 1}[unit]
        lo, hi = nanos // div, -(-nanos // div)
        if unit == "NANOS" or nanos % 1000:
            # NANOS rows yield Time; a sub-microsecond filter value on a
            # MILLIS/MICROS column keeps exact nanos too (dt.time would
            # truncate and flip comparisons) — row_matches converts the
            # row's dt.time to Time before comparing
            row_value = Time.from_nanos(nanos, utc=kind[2])
        else:
            micros = nanos // 1000
            row_value = dt.time(
                micros // 3_600_000_000,
                (micros // 60_000_000) % 60,
                (micros // 1_000_000) % 60,
                micros % 1_000_000,
            )
        return row_value, lo, hi
    raise FilterError(f"filter: unsupported logical type on {leaf.path_str}")


def _unit_bracket(micros: int, unit: str) -> tuple:
    """Floor/ceil of a microsecond instant in the column's stored unit."""
    if unit == "MILLIS":
        return micros // 1000, -(-micros // 1000)
    if unit == "NANOS":
        return micros * 1000, micros * 1000
    return micros, micros


def _decode_stat(leaf, raw: bytes, legacy: bool):
    """PLAIN-encoded chunk statistic -> comparable physical value."""
    if raw is None:
        return None
    t = leaf.type
    try:
        if t in (Type.INT32, Type.INT64) and _is_unsigned(leaf):
            if legacy:
                # deprecated min/max were computed with SIGNED comparison by
                # old writers; decoding them unsigned inverts the ordering for
                # values with the top bit set — unusable for pruning
                return None
            return _UNSIGNED[t].unpack(raw)[0]
        fmt = _PACK.get(t)
        if fmt is not None:
            return fmt.unpack(raw)[0]
        if t == Type.BOOLEAN:
            return bool(raw[0])
    except (struct.error, IndexError):
        return None  # malformed stats: never prune on them
    if legacy:
        # deprecated min/max used signed-byte comparison for binary in old
        # writers (parquet-format ORDER caveat): unsafe to prune on
        return None
    return bytes(raw)  # byte arrays compare lexicographically (min/max_value)


def _bounds_admit(op, vlo, vhi, lo, hi, null_count) -> bool:
    """Whether a [lo, hi] stat range (with null_count) may contain a match
    for op against the [vlo, vhi] bracket of the filter value. Shared by
    row-group pruning (chunk statistics) and page pruning (ColumnIndex).

    [vlo, vhi] brackets the filter value in the stat domain; vlo != vhi
    means the value falls between representable stored values, so each
    comparison uses the end that keeps pruning conservative."""
    if op == "contains":
        # a list can only contain the value if some ELEMENT equals it, and
        # the stats bracket the element values — equality semantics
        op = "=="
    if op == "in":
        # admits iff ANY member could be present ([] provably matches nothing)
        return any(
            _bounds_admit("==", a, b, lo, hi, null_count) for a, b in vlo
        )
    if op == "not_in":
        return True  # a range can't prove every row is in the set
    if op == "==" and (vlo != vhi or vhi < lo or vlo > hi):
        return False  # inexact value: NO stored value can equal it
    if op == "<" and lo >= vhi:
        return False
    if op == "<=" and lo > vlo:
        return False
    if op == ">" and hi <= vlo:
        return False
    if op == ">=" and hi < vhi:
        return False
    # "!=" can only be pruned when lo == hi == value and nothing is null
    if op == "!=" and vlo == vhi and lo == hi == vlo and not null_count:
        return False
    return True


def chunks_by_path(rg) -> dict:
    """{leaf path: ColumnChunk} for one row group, skipping chunks whose
    metadata is absent (mutated/corrupt footers must degrade, not crash)."""
    return {
        tuple(c.meta_data.path_in_schema or []): c
        for c in rg.columns or []
        if c.meta_data is not None
    }


def row_group_may_match(rg, normalized) -> bool:
    """False only when statistics PROVE no row of the group matches."""
    chunks = chunks_by_path(rg)
    for path, leaf, op, _row_value, vlo, vhi in normalized:
        cc = chunks.get(path)
        if cc is None:
            continue
        md = cc.meta_data
        st = md.statistics
        if st is None:
            continue
        null_count = st.null_count
        num_values = md.num_values or 0
        if op == "is_null":
            if null_count == 0:
                return False
            continue
        if op == "not_null":
            if null_count is not None and null_count >= num_values:
                return False
            continue
        if vlo is None:
            continue  # no orderable physical form for this column's stats
        legacy = st.min_value is None or st.max_value is None
        lo = _decode_stat(leaf, st.min_value if not legacy else st.min, legacy)
        hi = _decode_stat(leaf, st.max_value if not legacy else st.max, legacy)
        if lo is None or hi is None:
            continue
        # NaN bounds make float stats unusable for ordering
        if isinstance(lo, float) and (lo != lo or hi != hi):
            continue
        if not _bounds_admit(op, vlo, vhi, lo, hi, null_count):
            return False
    return True


def normalize_dnf(schema: Schema, filters) -> list:
    """Normalize a predicate into disjunctive normal form: a list of
    normalized conjunctions (OR of ANDs).

    Accepts pyarrow's convention: a flat list of (column, op, value) triples
    is one conjunction; a list of LISTS of triples is an OR of conjunctions.
    Disambiguation matches pyarrow: an element whose first item is a string
    is a TRIPLE (so JSON-style list-triples like ["id", "==", 3] stay a flat
    conjunction), and only all-list elements with non-string heads form DNF.
    """
    filters = list(filters)  # may be a generator: iterate exactly once
    if filters and all(
        isinstance(c, list) and c and not isinstance(c[0], str) for c in filters
    ):
        return [normalize_filters(schema, c) for c in filters]
    if filters and all(isinstance(c, list) for c in filters) and any(
        not c for c in filters
    ):
        raise FilterError("filter: empty conjunction in OR-of-ANDs form")
    return [normalize_filters(schema, filters)]


def dnf_group_may_match(rg, dnf, bloom_excludes=None, group_index=None) -> bool:
    """A group survives when ANY conjunction admits it (and, when a
    bloom_excludes(i, conjunction) callback is given, isn't bloom-proven
    empty for that conjunction)."""
    for conj in dnf:
        if not row_group_may_match(rg, conj):
            continue
        if bloom_excludes is not None and bloom_excludes(group_index, conj):
            continue
        return True
    return False


def page_ranges_matching(normalized, indexes, num_rows: int):
    """Row ranges of one row group that may hold matching rows, proven by
    the page index ({path: (ColumnIndex, OffsetIndex)}). Returns a sorted
    disjoint [(start, stop)] list; [(0, num_rows)] when nothing can be
    pruned. Conservative: a range is dropped only when every filter column's
    ColumnIndex PROVES its pages empty of matches."""
    ranges = [(0, num_rows)] if num_rows > 0 else []
    for path, leaf, op, _row_value, vlo, vhi in normalized:
        pair = indexes.get(path)
        if not pair:
            continue
        ci, oi = pair
        if ci is None or oi is None or not oi.page_locations:
            continue
        locs = oi.page_locations
        n_pages = len(locs)
        # a malformed/foreign index (thrift decodes lists independently, so
        # lengths can disagree, and first_row_index can be absent) must
        # degrade to "cannot prune on this column", never crash
        if (
            ci.null_pages is None
            or len(ci.null_pages) != n_pages
            or ci.min_values is None
            or len(ci.min_values) != n_pages
            or ci.max_values is None
            or len(ci.max_values) != n_pages
            or (ci.null_counts and len(ci.null_counts) != n_pages)
            or any(not isinstance(loc.first_row_index, int) for loc in locs)
            or locs[0].first_row_index < 0
            # non-monotonic row indexes would break the sorted-disjoint
            # contract of the range intersection below
            or any(
                b.first_row_index <= a.first_row_index
                for a, b in zip(locs, locs[1:])
            )
        ):
            continue
        nulls = ci.null_counts if ci.null_counts else [None] * n_pages
        keep = []
        for k, loc in enumerate(locs):
            start = loc.first_row_index
            stop = (
                locs[k + 1].first_row_index if k + 1 < n_pages else num_rows
            )
            if stop <= start:
                continue
            if _page_admits(
                leaf, op, vlo, vhi, ci.null_pages[k],
                ci.min_values[k], ci.max_values[k], nulls[k], stop - start,
            ):
                keep.append((start, stop))
        ranges = _intersect_ranges(ranges, keep)
        if not ranges:
            return []
    return _coalesce_ranges(ranges)


def dnf_page_ranges(dnf, indexes, num_rows: int):
    """Union of each conjunction's admitted row ranges."""
    all_ranges: list = []
    for conj in dnf:
        rs = page_ranges_matching(conj, indexes, num_rows)
        if rs == [(0, num_rows)]:
            return rs  # one conjunction admits everything
        all_ranges.extend(rs)
    all_ranges.sort()
    return _coalesce_ranges(all_ranges)


def _coalesce_ranges(rs):
    out: list = []
    for s, e in rs:
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _page_admits(leaf, op, vlo, vhi, is_null_page, min_raw, max_raw, null_count, rows):
    if is_null_page:
        return op == "is_null"
    if op == "is_null":
        return null_count is None or null_count > 0
    if op == "not_null":
        # rows counts ROWS; null_count counts level slots — only the
        # all-null proof is safe, and only for non-repeated columns
        return not (
            leaf.max_rep == 0 and null_count is not None and null_count >= rows
        )
    if vlo is None:
        return True
    lo = _decode_stat(leaf, min_raw, legacy=False)
    hi = _decode_stat(leaf, max_raw, legacy=False)
    if lo is None or hi is None:
        return True
    if isinstance(lo, float) and (lo != lo or hi != hi):
        return True
    return _bounds_admit(op, vlo, vhi, lo, hi, null_count)


def _intersect_ranges(a, b):
    """Intersection of two sorted disjoint [(start, stop)] lists."""
    out = []
    i = j = 0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if lo < hi:
            out.append((lo, hi))
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return out


def dnf_row_matches(row: dict, dnf) -> bool:
    return any(row_matches(row, conj) for conj in dnf)


def _lift_row_value(v, value):
    """Adapt a row value to the filter value's comparison domain."""
    if isinstance(v, str) and isinstance(value, bytes):
        return v.encode("utf-8")
    if isinstance(v, dt.time) and not isinstance(value, dt.time):
        # sub-microsecond TIME filter value on a MILLIS/MICROS column:
        # lift the row into exact-nanos Time space for the comparison
        from ..floor.time import Time

        if isinstance(value, Time):
            return Time.from_time(v, utc=value.utc)
    return v


def row_matches(row: dict, normalized) -> bool:
    for path, leaf, op, value, _vlo, _vhi in normalized:
        v = row.get(path[0]) if len(path) == 1 else _nested_get(row, path)
        if op == "is_null":
            if v is not None:
                return False
            continue
        if op == "not_null":
            if v is None:
                return False
            continue
        if op == "contains":
            # rows hold the unwrapped list under the TOP name (the leaf
            # path addresses the element for stats; normalize_filters pins
            # len-1 user paths, so path[0] is the top field)
            v = row.get(path[0])
            if not isinstance(v, list):
                return False  # null list, or not the expected shape
            if not any(
                e is not None and _lift_row_value(e, value) == value for e in v
            ):
                return False
            continue
        if v is None:
            return False
        if op in ("in", "not_in"):
            # members were unified into one domain at normalize time, so
            # the row value lifts once (against any member), not per member
            if value:
                lifted = _lift_row_value(v, next(iter(value)))
                hit = (
                    lifted in value
                    if isinstance(value, frozenset)
                    else any(lifted == x for x in value)
                )
            else:
                hit = False
            if hit == (op == "not_in"):
                return False
            continue
        v = _lift_row_value(v, value)
        if op == "==" and not v == value:
            return False
        if op == "!=" and not v != value:
            return False
        if op == "<" and not v < value:
            return False
        if op == "<=" and not v <= value:
            return False
        if op == ">" and not v > value:
            return False
        if op == ">=" and not v >= value:
            return False
    return True


def _nested_get(row, path):
    v = row
    for part in path:
        if not isinstance(v, dict):
            return None
        v = v.get(part)
        if v is None:
            return None
    return v
