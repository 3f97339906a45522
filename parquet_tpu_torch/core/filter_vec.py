"""Vectorized residual predicate evaluation on the host: filter -> row mask.

A copy of parquet_tpu/core/filter_vec.py cut to the mask pipeline
(`dnf_mask` and its comparators). In the port it is one rung below the
device engine (core/filter_device.py): a predicate the device declines is
evaluated here over the group's host-decoded chunks ({leaf path:
ChunkData} from FileReader.read_row_group) and the mask is uploaded; and
filter_device compares a chunk's host dictionary with these comparators
before one device gather lifts the verdict to rows. The port's host chunks
always carry their decoded values (it has no dictionary-preserving host
read), so the comparators run over `values`.

Each leaf predicate of the (already normalized) DNF compiles to one
boolean ndarray over the decoded buffers, conjunctions AND their leaf
masks, and disjunctions OR the conjunctions.

Comparisons happen in the PHYSICAL storage domain using the (stat_lo,
stat_hi) bracket normalize_filters already computes per value: lo == hi
means the filter value is exactly representable (compare against it);
lo != hi means it falls BETWEEN representable stored values (equality is
impossible, ordered comparisons use the end that keeps the answer exact).
Columns whose physical form has no usable ordering (INT96 timestamps,
binary-backed decimals) and shapes the pipeline does not cover raise the
typed VecFilterError.

Null semantics are selectable because the two consumers pin different
conventions:

  "row"    a null cell fails every value op (is_null/not_null see
           validity; not_in drops nulls too)
  "arrow"  pyarrow.parquet.read_table: identical EXCEPT not_in, where
           pc.invert(pc.is_in(...)) maps null to True (nulls are KEPT)

`("tags", "contains", x)` predicates mask at the list-SLOT level: the
element stream compares dense values once, and one scatter through the
record-start prefix scan (ops/levels.rows_from_rep) lifts element hits to
row membership.
"""

from __future__ import annotations

import numpy as np

from ..meta.parquet_types import Type
from ..ops.levels import rows_from_rep
from .arrays import ByteArrayData
from .assembly import logical_kind
from .filter import FilterError
from .stats import column_is_unsigned

__all__ = ["VecFilterError", "dnf_mask"]

# Guards against pathological byte-array shapes: padding n values to the
# longest value's width is the vectorized compare's only super-linear cost,
# so chunks with huge values (or a huge filter value) are refused.
_MAX_BYTES_WIDTH = 1 << 12
_MAX_PAD_BYTES = 256 << 20


class VecFilterError(FilterError):
    """The mask pipeline cannot evaluate this predicate over these buffers
    (unorderable physical domain, uncovered shape, pathological widths)."""


# -- mask combination ----------------------------------------------------------


def dnf_mask(chunks: dict, dnf, n_rows: int, *, null_mode: str = "row"):
    """bool[n_rows] row mask of a normalized DNF over one row group's
    decoded chunks ({leaf path: ChunkData}). Raises VecFilterError when any
    referenced predicate cannot vectorize — all or nothing."""
    if null_mode not in ("row", "arrow"):
        raise ValueError('null_mode must be "row" or "arrow"')
    cache: dict = {}
    out = None
    for conj in dnf:
        m = None
        for entry in conj:
            lm = _leaf_mask(chunks, entry, n_rows, null_mode, cache)
            m = lm if m is None else (m & lm)
        if m is None:  # empty conjunction is vacuously true
            return np.ones(n_rows, dtype=bool)
        out = m if out is None else (out | m)
    if out is None:
        return np.ones(n_rows, dtype=bool)
    return out


# -- per-leaf masks -------------------------------------------------------------


def _leaf_mask(chunks, entry, n_rows, null_mode, cache):
    path, leaf, op, value, vlo, vhi = entry
    cd = chunks.get(path)
    if cd is None:
        raise VecFilterError(f"filter_vec: column {'.'.join(path)} not decoded")
    if op == "contains":
        return _contains_mask(cd, leaf, vlo, vhi, n_rows, (path, cache))
    if leaf.max_rep != 0:
        raise VecFilterError(f"filter_vec: {'.'.join(path)} is repeated")
    if cd.num_values != n_rows:
        raise VecFilterError(
            f"filter_vec: {'.'.join(path)}: {cd.num_values} level entries "
            f"for {n_rows} rows"
        )
    valid = None
    if leaf.max_def > 0 and cd.def_levels is not None:
        v = np.asarray(cd.def_levels) == leaf.max_def
        if not v.all():
            valid = v
    if op == "is_null":
        if valid is None:
            return np.zeros(n_rows, dtype=bool)
        return ~valid
    if op == "not_null":
        if valid is None:
            return np.ones(n_rows, dtype=bool)
        return valid.copy()
    if op in ("in", "not_in") and null_mode == "arrow":
        # pyarrow's is_in CASTS the value set to the column type (unlike
        # its compare kernels, which promote the column): a float64 member
        # that is inexact in a float32 column matches under pc.is_in but
        # not under exact semantics — decline so the fallback decides
        if leaf.type == Type.FLOAT and isinstance(vlo, list) and any(
            lo is not None
            and isinstance(lo, float)
            and float(np.float32(lo)) != lo
            for lo, _ in vlo
        ):
            raise VecFilterError(
                f"filter_vec: {leaf.path_str}: in-list member inexact in "
                "float32 (pyarrow is_in casts the value set)"
            )
    cmp = _dense_compare(cd, leaf, op, vlo, vhi, (path, cache))
    if op == "not_in" and null_mode == "arrow":
        # pyarrow's pc.invert(pc.is_in(...)) maps null to True: nulls KEPT
        if valid is None:
            return cmp
        out = np.ones(n_rows, dtype=bool)
        out[valid] = cmp
        return out
    if valid is None:
        return cmp
    out = np.zeros(n_rows, dtype=bool)
    out[valid] = cmp
    return out


def _contains_mask(cd, leaf, vlo, vhi, n_rows, ckey):
    """List-slot membership: compare the dense element values once, then
    lift element hits to their rows through the record-start scan."""
    if cd.rep_levels is None:
        raise VecFilterError(
            f"filter_vec: {leaf.path_str}: contains without repetition levels"
        )
    rl = np.asarray(cd.rep_levels)
    if len(rl) and int(rl[0]) != 0:
        raise VecFilterError(f"filter_vec: {leaf.path_str}: stream opens mid-record")
    starts = rows_from_rep(rl)
    if len(starts) != n_rows:
        raise VecFilterError(
            f"filter_vec: {leaf.path_str}: {len(starts)} records for {n_rows} rows"
        )
    # which row each level entry belongs to (inclusive prefix count of starts)
    row_of = np.cumsum(rl == 0) - 1
    if cd.def_levels is not None:
        valid = np.asarray(cd.def_levels) == leaf.max_def
        row_of = row_of[valid]
    cmp = _dense_compare(cd, leaf, "==", vlo, vhi, ckey)
    if len(cmp) != len(row_of):
        raise VecFilterError(f"filter_vec: {leaf.path_str}: level/value mismatch")
    out = np.zeros(n_rows, dtype=bool)
    out[row_of[cmp]] = True
    return out


# -- dense value comparison -----------------------------------------------------


def _dense_compare(cd, leaf, op, vlo, vhi, ckey):
    """bool mask over the chunk's DENSE (non-null) values for one value op,
    in the physical domain. `vlo`/`vhi` bracket the filter value (for
    in/not_in, vlo is the list of member brackets)."""
    if vlo is None:
        raise VecFilterError(
            f"filter_vec: {leaf.path_str}: no orderable physical form"
        )
    if op in ("in", "not_in"):
        if any(lo is None for lo, _ in vlo):
            raise VecFilterError(
                f"filter_vec: {leaf.path_str}: unorderable in-list member"
            )
        exact = [lo for lo, hi in vlo if lo == hi]
        m = _member_mask(cd.values, leaf, exact, ckey)
        return ~m if op == "not_in" else m
    return _raw_compare(cd.values, leaf, op, vlo, vhi, ckey)


def _member_mask(target, leaf, members, ckey):
    """OR of equality masks of a value buffer (a chunk's dense values, or a
    host dictionary) for the exactly-representable in-list members (an
    inexact bracket can equal no stored value: it contributes nothing)."""
    if target is None:
        raise VecFilterError(f"filter_vec: {leaf.path_str}: no value buffer")
    if not members:
        return np.zeros(len(target), dtype=bool)
    if isinstance(target, ByteArrayData):
        m = None
        for b in members:
            em = _bytes_compare(target, "==", b, ckey)
            m = em if m is None else (m | em)
        return m
    if isinstance(target, np.ndarray) and target.ndim == 1:
        arr = _numeric_view(target, leaf)
        try:
            return np.isin(arr, np.array(members))
        except (OverflowError, TypeError, ValueError) as e:
            raise VecFilterError(
                f"filter_vec: {leaf.path_str}: in-list not comparable: {e}"
            ) from None
    m = None
    for b in members:
        em = _raw_compare(target, leaf, "==", b, b, ckey)
        m = em if m is None else (m | em)
    return m


def _numeric_view(arr, leaf):
    """The chunk's 1-D numeric array in its COMPARISON domain: unsigned
    logical types reinterpret the stored bit pattern (a view and a
    sub-width mask)."""
    if column_is_unsigned(leaf):
        kind = logical_kind(leaf)
        bits = kind[1] if isinstance(kind, tuple) and kind[0] == "uint" else None
        u = arr.view(arr.dtype.newbyteorder("="))
        if u.dtype == np.int32:
            u = u.view(np.uint32)
        elif u.dtype == np.int64:
            u = u.view(np.uint64)
        if bits is not None and bits < u.dtype.itemsize * 8:
            u = u & np.array((1 << bits) - 1, dtype=u.dtype)
        return u
    return arr


def _raw_compare(values, leaf, op, vlo, vhi, ckey):
    if isinstance(values, ByteArrayData):
        # bytes brackets are always exact (vlo is the value itself)
        return _bytes_compare(values, op, vlo, ckey)
    arr = np.asarray(values)
    if arr.ndim == 2:
        return _fixed_compare(arr, op, vlo)
    if arr.dtype == np.bool_:
        arr = arr.astype(np.int8)
        vlo, vhi = int(vlo), int(vhi)
    else:
        arr = _numeric_view(arr, leaf)
    try:
        return _bracket_compare(arr, op, vlo, vhi)
    except (OverflowError, TypeError) as e:
        # a filter value outside the dtype's range (or an exotic type numpy
        # refuses to coerce)
        raise VecFilterError(
            f"filter_vec: {leaf.path_str}: not comparable vectorized: {e}"
        ) from None


def _bracket_compare(arr, op, lo, hi):
    """Ordered/equality comparison against the [lo, hi] physical bracket of
    the filter value x. lo == hi: x is exactly representable. lo != hi:
    lo < x < hi with no representable value between, so equality is
    impossible and each ordered op uses the end that stays exact. A NaN
    filter value brackets as (nan, nan) — `lo == hi` is then False, and the
    inexact branches below return all-False/all-True exactly like Python's
    NaN comparisons."""
    exact = lo == hi
    if op == "==":
        return (arr == lo) if exact else np.zeros(len(arr), dtype=bool)
    if op == "!=":
        return (arr != lo) if exact else np.ones(len(arr), dtype=bool)
    if op == "<":
        return (arr < lo) if exact else (arr <= lo)
    if op == "<=":
        return arr <= lo
    if op == ">":
        return (arr > hi) if exact else (arr >= hi)
    if op == ">=":
        return arr >= hi
    raise VecFilterError(f"filter_vec: unsupported op {op!r}")


def _fixed_compare(arr, op, value):
    """FIXED_LEN_BYTE_ARRAY rows ((n, width) uint8): equality family only —
    the sign/byte-order conventions that would make ordered comparisons
    meaningful vary by logical type, and normalize_filters already maps the
    orderable ones (int-backed decimals) to integer brackets."""
    if op not in ("==", "!="):
        raise VecFilterError("filter_vec: ordered comparison on fixed-width bytes")
    b = bytes(value)
    if arr.shape[1] != len(b):
        eq = np.zeros(len(arr), dtype=bool)
    elif arr.shape[1] == 0:
        eq = np.ones(len(arr), dtype=bool)
    else:
        eq = (arr == np.frombuffer(b, dtype=np.uint8)).all(axis=1)
    return eq if op == "==" else ~eq


def _bytes_compare(ba: ByteArrayData, op, value, ckey):
    """Variable-length byte/string comparison, vectorized via one padded
    fixed-width view. numpy's S-dtype compares null-PADDED values — exactly
    the stored bytes except that trailing NULs tie — so every op breaks
    S-ties with the true lengths (a longer value whose prefix matches is
    the greater one) and the result is exact for arbitrary bytes.
    UTF-8 byte order equals code-point order, so str predicates coerced to
    bytes by normalize_filters compare in code-point order."""
    b = bytes(value)
    S, lens, width = _padded_bytes(ba, len(b), ckey)
    eq_s = S == b
    if op == "==":
        return eq_s & (lens == len(b))
    if op == "!=":
        return ~(eq_s & (lens == len(b)))
    if op == "<":
        return (S < b) | (eq_s & (lens < len(b)))
    if op == "<=":
        return (S < b) | (eq_s & (lens <= len(b)))
    if op == ">":
        return (S > b) | (eq_s & (lens > len(b)))
    if op == ">=":
        return (S > b) | (eq_s & (lens >= len(b)))
    raise VecFilterError(f"filter_vec: unsupported op {op!r}")


def _padded_bytes(ba: ByteArrayData, min_width: int, ckey):
    """(S-dtype array[n], int64 lengths[n], width) for one buffer's byte
    values, padded to max(longest value, the filter value) — cached per
    leaf path across the predicates of one DNF so a column referenced in N
    conjunctions pads once."""
    path, cache = ckey
    hit = cache.get(path)
    if hit is not None and hit[2] >= min_width:
        return hit
    offs = np.asarray(ba.offsets, dtype=np.int64)
    lens = np.diff(offs)
    n = len(lens)
    maxlen = int(lens.max()) if n else 0
    width = max(maxlen, min_width, 1)
    if width > _MAX_BYTES_WIDTH or n * width > _MAX_PAD_BYTES:
        raise VecFilterError(
            f"filter_vec: byte values too wide to pad ({width} B x {n})"
        )
    padded = np.zeros((n, width), dtype=np.uint8)
    if n and int(offs[-1] - offs[0]):
        src = np.frombuffer(ba.data, dtype=np.uint8)[offs[0] : offs[-1]]
        row_of = np.repeat(np.arange(n, dtype=np.int64), lens)
        within = np.arange(len(src), dtype=np.int64) - np.repeat(
            offs[:-1] - offs[0], lens
        )
        padded.reshape(-1)[row_of * width + within] = src
    S = padded.view(f"S{width}")[:, 0]
    out = (S, lens, width)
    cache[path] = out
    return out
