"""General Dremel-levels -> Arrow assembly for to_arrow's nested shapes.

The port's copy of parquet_tpu/core/arrow_nested.py. The flat and
canonical-LIST fast paths live in reader.to_arrow; this module covers
everything else — structs, MAPs, multi-level lists, list-of-struct,
struct-of-list, legacy repeated groups/leaves — by converting the
offsets/validity intermediate the vectorized assembly engine builds
(core/assembly_vec.build_field_vec, mode="arrow") into Arrow arrays: the
SAME level prefix scan feeds row assembly and to_arrow, handed off at the
buffer level — offsets, null masks and dense value slices are shared
NumPy/chunk buffers, never re-derived or touched row by row.

The arrays are the port's own (core/arrow_format.py, passed in as `pa`,
where the reference passes pyarrow): leaf array construction over the
dense value slice (buffer handoff for byte arrays, retyping to logical
Arrow types), list/map/struct array assembly from IR offsets and masks,
and the Arrow type derivation (nested_arrow_type) that the builder's
dispatch must match exactly.
"""

from __future__ import annotations

import numpy as np

from ..meta.file_meta import ParquetFileError
from ..meta.parquet_types import ConvertedType, FieldRepetitionType, Type

__all__ = ["build_top_field", "nested_arrow_type", "retype_leaf"]


def _is_list_annotated(node) -> bool:
    return (
        node.converted_type == ConvertedType.LIST
        and not node.is_leaf
        and len(node.children) == 1
        and node.children[0].repetition == FieldRepetitionType.REPEATED
        and not node.children[0].is_leaf
    )


def _is_map_annotated(node) -> bool:
    if node.converted_type not in (ConvertedType.MAP, ConvertedType.MAP_KEY_VALUE):
        return False
    if node.is_leaf or len(node.children) != 1:
        return False
    kv = node.children[0]
    return (
        kv.repetition == FieldRepetitionType.REPEATED
        and not kv.is_leaf
        and len(kv.children) == 2
    )


def _leaf_storage_type(pa, leaf):
    """The Arrow type of the STORAGE array the builders produce (physical
    parquet layout, before logical-type conversion)."""
    if leaf.type == Type.BYTE_ARRAY:
        return pa.large_string() if leaf.is_string() else pa.large_binary()
    if leaf.type in (Type.FIXED_LEN_BYTE_ARRAY, Type.INT96):
        return pa.binary(12 if leaf.type == Type.INT96 else leaf.type_length)
    return {
        Type.INT32: pa.int32(),
        Type.INT64: pa.int64(),
        Type.FLOAT: pa.float32(),
        Type.DOUBLE: pa.float64(),
        Type.BOOLEAN: pa.bool_(),
    }[leaf.type]


def _logical_target(pa, leaf):
    """The FINAL Arrow type the leaf's logical/converted annotation maps to
    (pyarrow.parquet.read_table's convention), or None when the storage
    type IS the final type (strings, plain numerics, unannotated binary)."""
    t = leaf.type
    if t == Type.INT96:
        return pa.timestamp("ns")  # Impala/Hive timestamps; pyarrow: ns
    lt = leaf.logical_type
    ct = leaf.converted_type
    if lt is not None:
        if lt.TIMESTAMP is not None and t == Type.INT64:
            u = lt.TIMESTAMP.unit
            unit = (
                "ms" if u and u.MILLIS is not None
                else "ns" if u and u.NANOS is not None
                else "us"
            )
            tz = "UTC" if lt.TIMESTAMP.isAdjustedToUTC else None
            return pa.timestamp(unit, tz=tz)
        if lt.TIME is not None:
            # Spec-pinned unit/physical pairs only: MILLIS stores INT32,
            # MICROS/NANOS store INT64. Any other combination (a foreign
            # writer annotating TIME(MILLIS) on INT64, a missing unit) is
            # spec-invalid: keep raw storage rather than silently misreading
            # the values in a wrong unit.
            u = lt.TIME.unit
            if u is not None and u.MILLIS is not None:
                return pa.time32("ms") if t == Type.INT32 else None
            if u is not None and u.MICROS is not None:
                return pa.time64("us") if t == Type.INT64 else None
            if u is not None and u.NANOS is not None:
                return pa.time64("ns") if t == Type.INT64 else None
            return None
        if lt.DATE is not None and t == Type.INT32:
            return pa.date32()
        if lt.DECIMAL is not None:
            return _decimal_type(pa, leaf, lt.DECIMAL.precision, lt.DECIMAL.scale)
        if lt.INTEGER is not None:
            return _int_arrow_type(pa, lt.INTEGER.bitWidth, bool(lt.INTEGER.isSigned))
        if (
            lt.FLOAT16 is not None
            and t == Type.FIXED_LEN_BYTE_ARRAY
            and leaf.type_length == 2  # spec-invalid widths stay raw binary
        ):
            return pa.float16()
        # UUID/JSON extension types deliberately NOT mapped, as in the
        # reference: they stay raw binary
        return None
    if ct is None:
        return None
    if ct == ConvertedType.DATE and t == Type.INT32:
        return pa.date32()
    if ct == ConvertedType.TIME_MILLIS and t == Type.INT32:
        return pa.time32("ms")
    if ct == ConvertedType.TIME_MICROS and t == Type.INT64:
        return pa.time64("us")
    if ct == ConvertedType.TIMESTAMP_MILLIS and t == Type.INT64:
        return pa.timestamp("ms")
    if ct == ConvertedType.TIMESTAMP_MICROS and t == Type.INT64:
        return pa.timestamp("us")
    if ct == ConvertedType.DECIMAL:
        el = leaf.element
        return _decimal_type(pa, leaf, el.precision, el.scale)
    ints = {
        # INT_32/INT_64 omitted: identity with the storage type
        ConvertedType.UINT_8: (8, False), ConvertedType.UINT_16: (16, False),
        ConvertedType.UINT_32: (32, False), ConvertedType.UINT_64: (64, False),
        ConvertedType.INT_8: (8, True), ConvertedType.INT_16: (16, True),
    }
    if ct in ints:
        return _int_arrow_type(pa, *ints[ct])
    return None


def _int_arrow_type(pa, bit_width, signed: bool):
    m = {
        (8, True): pa.int8, (16, True): pa.int16,
        (32, True): pa.int32, (64, True): pa.int64,
        (8, False): pa.uint8, (16, False): pa.uint16,
        (32, False): pa.uint32, (64, False): pa.uint64,
    }
    f = m.get((bit_width, signed))
    return f() if f is not None else None


def _decimal_type(pa, leaf, precision, scale):
    if precision is None or not 1 <= precision <= 38:
        return None  # >38 needs decimal256; malformed: keep storage
    if leaf.type in (Type.INT32, Type.INT64):
        return pa.decimal128(precision, scale or 0)
    if leaf.type == Type.FIXED_LEN_BYTE_ARRAY and 1 <= (leaf.type_length or 0) <= 16:
        # pyarrow's own bound: FromBigEndian accepts 1..16 bytes; wider
        # FLBA decimals error in pyarrow, so they stay raw binary here
        return pa.decimal128(precision, scale or 0)
    return None  # BYTE_ARRAY-backed decimals: keep raw bytes


def _leaf_arrow_type(pa, leaf):
    """The FINAL Arrow type for a leaf (logical conversion applied)."""
    return _logical_target(pa, leaf) or _leaf_storage_type(pa, leaf)


def retype_leaf(pa, leaf, arr):
    """Convert a STORAGE array to the leaf's final Arrow type: zero-copy
    view() where widths agree (timestamps, date32, time, uint32/64,
    float16), compute cast for narrowing ints, and buffer rebuilds for
    decimal128 and INT96->timestamp[ns]. Mirrors pyarrow.read_table's
    logical-type handling so a pyarrow user sees the same schema."""
    ft = _logical_target(pa, leaf)
    if ft is None or arr.type == ft:
        return arr
    if arr.offset != 0:  # rebase so raw-buffer math below is position 0
        arr = pa.concat_arrays([arr])
    if pa.types.is_decimal(ft):
        return _to_decimal128(pa, leaf, arr, ft)
    if leaf.type == Type.INT96:
        return _int96_to_timestamp(pa, arr, ft)
    bw = {pa.int8(): 8, pa.int16(): 16, pa.uint8(): 8, pa.uint16(): 16}
    if ft in bw:
        try:
            # narrowing: our own writer's values fit by construction, but a
            # malformed FOREIGN file can annotate INT_8/UINT_16/... on stored
            # values outside the annotated range — fail through the
            # documented error surface, not a raw pyarrow exception
            return arr.cast(ft)
        except pa.ArrowInvalid as e:
            raise ParquetFileError(
                f"parquet: stored values overflow annotated type {ft}: {e}"
            ) from e
    return arr.view(ft)  # same-width reinterpretation, zero-copy


def fixed_width_rows(values, leaf) -> np.ndarray:
    """A leaf chunk's dense values as a NumPy array; an FLBA or INT96
    chunk with no non-null cell decodes to an empty 1-D array, which
    takes its rows' width here so it builds as the leaf's fixed type."""
    np_vals = np.asarray(values)
    if np_vals.ndim == 1 and leaf.type in (Type.FIXED_LEN_BYTE_ARRAY, Type.INT96):
        np_vals = np_vals.reshape(-1, 12 if leaf.type == Type.INT96 else leaf.type_length)
    return np_vals


def _validity(arr):
    bufs = arr.buffers()
    return bufs[0] if bufs else None


def _to_decimal128(pa, leaf, arr, ft):
    n = len(arr)
    out = np.zeros((n, 16), dtype=np.uint8)
    if leaf.type in (Type.INT32, Type.INT64):
        npdt = np.int32 if leaf.type == Type.INT32 else np.int64
        v = np.frombuffer(arr.buffers()[1], dtype=npdt, count=n).astype(np.int64)
        lohi = out.view(np.int64).reshape(n, 2)
        lohi[:, 0] = v
        lohi[:, 1] = v >> 63  # sign extension
    else:  # FLBA big-endian two's complement, width 1..16 (_decimal_type)
        w = leaf.type_length or 0
        m = np.frombuffer(arr.buffers()[1], dtype=np.uint8, count=n * w).reshape(n, w)
        out[:, :w] = m[:, ::-1]  # BE -> LE
        out[m[:, 0] >= 0x80, w:] = 0xFF
    return pa.Array.from_buffers(
        ft, n, [_validity(arr), pa.py_buffer(out)], null_count=arr.null_count
    )


def _int96_to_timestamp(pa, arr, ft):
    n = len(arr)
    m = np.frombuffer(arr.buffers()[1], dtype=np.uint8, count=n * 12).reshape(n, 12)
    nanos = np.ascontiguousarray(m[:, :8]).view("<u8").reshape(n)
    days = np.ascontiguousarray(m[:, 8:12]).view("<u4").reshape(n)
    ns = (days.astype(np.int64) - 2440588) * 86_400_000_000_000 + nanos.astype(
        np.int64
    )
    return pa.Array.from_buffers(
        ft, n, [_validity(arr), pa.py_buffer(ns)], null_count=arr.null_count
    )


def nested_arrow_type(pa, node, selected=None):
    """The Arrow type this builder produces for a schema node.

    ``selected`` (a set of leaf paths, or None for all) prunes struct
    members whose leaves are projected out — mirroring _build_struct's
    data-side skip, so a projected read and its zero-row schema agree."""
    if node.is_leaf:
        base = _leaf_arrow_type(pa, node)
        if node.repetition == FieldRepetitionType.REPEATED:
            return pa.large_list(base)  # legacy bare repeated primitive
        return base
    if _is_map_annotated(node):
        kv = node.children[0]
        if not all(_selects(selected, c) for c in kv.children):
            # key or value projected out: no Arrow MAP without both —
            # degrade to the underlying list-of-struct shape (pruned)
            return pa.large_list(_struct_type(pa, kv, selected))
        return pa.map_(
            nested_arrow_type(pa, kv.children[0], selected),
            nested_arrow_type(pa, kv.children[1], selected),
        )
    if _is_list_annotated(node):
        rep = node.children[0]
        if len(rep.children) == 1:
            elem = rep.children[0]
            return pa.large_list(nested_arrow_type(pa, elem, selected))
        # canonical list whose repeated group holds several fields:
        # list of structs
        return pa.large_list(_struct_type(pa, rep, selected))
    if node.repetition == FieldRepetitionType.REPEATED:
        # legacy repeated group: list of structs, elements non-null
        return pa.large_list(_struct_type(pa, node, selected))
    return _struct_type(pa, node, selected)


def _selects(selected, node) -> bool:
    if selected is None:
        return True
    k = len(node.path)
    return any(p[:k] == node.path for p in selected)


def _struct_type(pa, node, selected=None):
    return pa.struct(
        [
            pa.field(
                c.name,
                nested_arrow_type(pa, c, selected),
                nullable=c.repetition != FieldRepetitionType.REQUIRED,
            )
            for c in node.children
            if _selects(selected, c)
        ]
    )


def build_top_field(pa, schema, top_name: str, chunks: dict) -> "pa.Array":
    """Assemble one top-level field (all its leaf chunks from one row group)
    into an Arrow array of length = the group's row count, by converting
    the assembly engine's offsets/validity IR."""
    from .assembly_vec import VecStructureError, build_field_vec

    sub = {p: cd for p, cd in chunks.items() if p[0] == top_name}
    if not sub:
        raise ParquetFileError(f"parquet: no leaf chunks for field {top_name}")
    try:
        vec, _n = build_field_vec(schema, top_name, sub, mode="arrow")
    except VecStructureError as e:
        raise ParquetFileError(f"parquet: {e}") from e
    return _field_from_vec(pa, vec)


def _field_from_vec(pa, vec):
    """IR node -> Arrow array. Offsets/null-mask ndarrays and dense leaf
    buffers pass through without per-row work."""
    from .assembly_vec import LeafVec, ListVec

    if isinstance(vec, LeafVec):
        return _leaf_array(pa, vec)

    if isinstance(vec, ListVec):
        valid = None if vec.null_mask is None else vec.null_mask == 0
        if vec.kind == "map":
            # arrow mode guarantees both kv children selected here
            keys = _field_from_vec(pa, vec.child.children[0])
            items = _field_from_vec(pa, vec.child.children[1])
            off32 = vec.offsets.astype(np.int32)
            if valid is not None:
                # a null offset at i marks map i null; the final offset (the
                # appended False) must stay valid
                moff = pa.array(
                    off32,
                    mask=np.append(vec.null_mask.astype(bool), False),
                    type=pa.int32(),
                )
                return pa.MapArray.from_arrays(moff, keys, items)
            return pa.MapArray.from_arrays(
                pa.array(off32, type=pa.int32()), keys, items
            )
        values = _field_from_vec(pa, vec.child)
        return _list_with_validity(pa, vec.offsets, values, valid)

    # StructVec
    children = []
    fields = []
    for name, child_vec in zip(vec.names, vec.children):
        arr = _field_from_vec(pa, child_vec)
        children.append(arr)
        fields.append(
            pa.field(
                name,
                arr.type,
                nullable=child_vec.node.repetition != FieldRepetitionType.REQUIRED,
            )
        )
    mask = None
    if vec.null_mask is not None:
        mask = pa.array(vec.null_mask.astype(bool))
    return pa.StructArray.from_arrays(children, fields=fields, mask=mask)


def _list_with_validity(pa, offsets, values, valid):
    if valid is not None and not valid.all():
        # a null offset at i marks list i null; the final offset (the
        # appended False) must stay valid
        return pa.LargeListArray.from_arrays(
            pa.array(
                offsets.astype(np.int64),
                mask=np.append(~valid, False),
                type=pa.int64(),
            ),
            values,
        )
    return pa.LargeListArray.from_arrays(offsets, values)


def _leaf_array(pa, vec):
    """Build a LeafVec's Arrow array (one entry per slot). The dense values
    of the selected entries are one contiguous slice of the chunk: a
    value-bearing entry (def == max_def) can never be dropped by a list
    filter above it."""
    from .arrays import ByteArrayData

    leaf = vec.node
    values = vec.chunk.values
    n_slots = vec.n
    nv = vec.nv
    k0 = vec.k0
    valid = vec.valid  # bool[n_slots] | None (None = every slot present)
    mask = None if valid is None else ~valid

    if isinstance(values, ByteArrayData):
        atype = pa.large_string() if leaf.is_string() else pa.large_binary()
        all_offsets = np.asarray(values.offsets, dtype=np.int64)
        dense_off = all_offsets[k0 : k0 + nv + 1]
        if mask is None:
            out_off = np.zeros(n_slots + 1, dtype=np.int64)
            if nv:
                np.cumsum(np.diff(dense_off), out=out_off[1:])
        else:
            lens = np.zeros(n_slots, dtype=np.int64)
            if nv:
                lens[valid] = np.diff(dense_off)
            out_off = np.zeros(n_slots + 1, dtype=np.int64)
            np.cumsum(lens, out=out_off[1:])
        data = values.data[
            int(dense_off[0]) if nv else 0 : int(dense_off[-1]) if nv else 0
        ]
        bufs = [
            None
            if mask is None
            else pa.py_buffer(np.packbits(valid, bitorder="little").tobytes()),
            pa.py_buffer(out_off),
            pa.py_buffer(data),
        ]
        return pa.Array.from_buffers(
            atype, n_slots, bufs, null_count=int(mask.sum()) if mask is not None else 0
        )  # byte-array leaves have no logical retype (BYTE_ARRAY decimals stay raw)

    np_vals = fixed_width_rows(values, leaf)
    if np_vals.ndim == 2:  # FLBA / INT96 byte rows
        atype = pa.binary(np_vals.shape[1])
        dense = np_vals[k0 : k0 + nv]
        if mask is None:
            flat = np.ascontiguousarray(dense).reshape(-1)
            built = pa.Array.from_buffers(atype, n_slots, [None, pa.py_buffer(flat)])
        else:
            it = iter(dense)
            rows = [bytes(next(it)) if ok else None for ok in valid]
            built = pa.array(rows, atype)
        return retype_leaf(pa, leaf, built)

    dense = np_vals[k0 : k0 + nv]
    if mask is None:
        return retype_leaf(pa, leaf, pa.array(dense))
    out = np.zeros(n_slots, dtype=np_vals.dtype)
    out[valid] = dense
    return retype_leaf(pa, leaf, pa.array(out, mask=mask))
