"""Vectorized Dremel record assembly: level prefix scans -> offsets/validity
-> rows by batched slicing.

A copy of parquet_tpu/core/assembly_vec.py without the C extension's row
builders: rows zip in Python here, as the JAX module does when its
extension is absent. Its "arrow" build mode feeds core/arrow_nested.py,
which hands the IR to the port's own Arrow arrays (core/arrow_format.py).

The scalar walk in core/assembly.py (RecordAssembler) rebuilds nested rows
one cursor step per level entry. This module is the data-parallel
formulation the rep/def-level model admits (reference schema.go:88-312):
whole-column prefix scans over each leaf's level streams — record
boundaries via rep == 0 (ops/levels.rows_from_rep), per-depth element
offsets via one prefix sum over the element-start mask gathered at slot
boundaries, null masks from each slot's first def level
(ops/levels.validity_from_def) — compute, in bulk NumPy, the offset and
null-mask arrays of every LIST/MAP/struct nesting depth: an Arrow-style
offsets+validity intermediate. Rows then materialize from it by batched
slicing, never touching values row by row.

The intermediate representation (IR) is a small tree mirroring the schema:

  LeafVec    one entry per slot: dense chunk values + a per-slot valid mask
  ListVec    offsets int64[n+1] + null mask over slots + element child
             (kind: "list" = annotated LIST to unwrap, "map" = annotated
             MAP -> dict, "repeated" = wire-shape repeated field)
  StructVec  named children at shared slot granularity + null mask

Three build modes share one recursion (core/arrow_nested.py consumes the
IR for to_arrow: the same scan feeds rows and Arrow):

  "rows"   ergonomic dispatch: LIST -> list, MAP -> dict, logical
           conversions — matches pyarrow to_pylist
  "raw"    wire shape: no unwrapping, bytes stay bytes — matches the
           reference's NextRow
  "arrow"  arrow_nested's dispatch (2-level legacy lists stay structs,
           MAP needs both key and value selected)

Engine selection: the reader (and RecordAssembler's iterator facade) uses
this engine by default; PQT_VEC_ASSEMBLY=0 forces the scalar walk — the
fallback for shapes the scans cannot prove, and the differential-test
oracle. Structural inconsistencies the scans detect cheaply raise the same
typed AssemblyError as the scalar walk; anything unprovable falls back to
the walk, which raises the precise per-row error (or proves the data fine).
"""

from __future__ import annotations

import os

import numpy as np

from ..meta.parquet_types import ConvertedType, FieldRepetitionType
from ..ops.levels import rows_from_rep, validity_from_def
from .assembly import AssemblyError, _leaf_python_values

__all__ = [
    "vec_enabled",
    "build_field_vec",
    "assemble_row_columns",
    "assemble_rows",
    "LeafVec",
    "ListVec",
    "StructVec",
    "VecStructureError",
    "slice_column",
]


def vec_enabled() -> bool:
    """The engine-selection knob: PQT_VEC_ASSEMBLY=0 forces the scalar
    cursor walk (the differential oracle) everywhere the vectorized engine
    would otherwise run."""
    return os.environ.get("PQT_VEC_ASSEMBLY", "1") != "0"


class VecStructureError(Exception):
    """Internal: the level streams describe a structure the vectorized scans
    cannot prove (leaves disagree, stream opens mid-slot, missing level
    arrays). Row callers fall back to the scalar walk — which raises the
    precise typed error if the data really is inconsistent."""

    pass


# -- the offsets/validity IR ----------------------------------------------------


class LeafVec:
    """One leaf at some slot granularity: slot i holds dense value
    k0 + (number of valid slots before i) when valid, else None."""

    __slots__ = ("node", "chunk", "valid", "k0", "nv", "n")

    def __init__(self, node, chunk, valid, k0: int, nv: int, n: int):
        self.node = node
        self.chunk = chunk
        self.valid = valid  # bool[n] | None (None = every slot present)
        self.k0 = k0  # first dense value index in chunk.values
        self.nv = nv  # dense value count over these slots
        self.n = n

    def null_count(self) -> int:
        return 0 if self.valid is None else self.n - self.nv


class ListVec:
    """A repeated depth: slot i's elements are child slots
    [offsets[i], offsets[i+1]); null_mask marks slots that are None (null
    wrapper) rather than empty."""

    __slots__ = ("node", "rep_node", "offsets", "null_mask", "child", "kind", "n")

    def __init__(self, node, rep_node, offsets, null_mask, child, kind: str):
        self.node = node  # the field this materializes as (wrapper or rep node)
        self.rep_node = rep_node  # the REPEATED schema node that was expanded
        self.offsets = offsets  # int64[n + 1]
        self.null_mask = null_mask  # uint8[n] | None (1 = slot is None)
        self.child = child
        self.kind = kind  # "list" | "map" | "repeated"
        self.n = len(offsets) - 1


class StructVec:
    """A group at some slot granularity: children share the slot space."""

    __slots__ = ("node", "names", "children", "null_mask", "n")

    def __init__(self, node, names, children, null_mask, n: int):
        self.node = node
        self.names = names
        self.children = children
        self.null_mask = null_mask  # uint8[n] | None
        self.n = n


# -- per-leaf stream state ------------------------------------------------------


class _Stream:
    __slots__ = ("leaf", "chunk", "rl", "dl", "n")

    def __init__(self, leaf, chunk):
        self.leaf = leaf
        self.chunk = chunk
        self.n = chunk.num_values
        rl = chunk.rep_levels
        dl = chunk.def_levels
        # widen PackedLevels / uint16 once; all scans below are comparisons
        self.rl = None if rl is None else np.asarray(rl)
        self.dl = None if dl is None else np.asarray(dl)


def _is_list_node(node, mode: str) -> bool:
    ct = node.converted_type
    if mode == "arrow":
        # must match arrow_nested.nested_arrow_type's dispatch exactly
        # (converted type only), or the built array and the declared type
        # would disagree
        return ct == ConvertedType.LIST
    lt = node.logical_type
    return ct == ConvertedType.LIST or (lt is not None and lt.LIST is not None)


def _is_map_node(node, mode: str) -> bool:
    ct = node.converted_type
    if mode == "arrow":
        return ct in (ConvertedType.MAP, ConvertedType.MAP_KEY_VALUE)
    lt = node.logical_type
    return ct in (ConvertedType.MAP, ConvertedType.MAP_KEY_VALUE) or (
        lt is not None and lt.MAP is not None
    )


def _covered(node, streams) -> bool:
    if node.is_leaf:
        return node.path in streams
    return any(_covered(c, streams) for c in node.children)


# -- the builder ----------------------------------------------------------------
#
# State per leaf during the recursion: a _View of the leaf's level arrays
# restricted to the current node's element stream, plus the positions where
# each slot begins. Three invariants keep every step O(n) ndarray math with
# no searchsorted/bincount:
#   * a value-bearing entry (def == leaf.max_def) survives every list
#     filter, so the selected dense values are one contiguous slice from 0;
#   * every slot at struct granularity keeps exactly one entry per leaf;
#   * a no-element placeholder (def below the depth's threshold) is always
#     its slot's SINGLE entry, so per-slot counts are segment lengths minus
#     the placeholder marker — one diff, no scatter.


class _View:
    """One leaf's level streams at the current node's granularity."""

    __slots__ = ("rl", "dl", "starts", "n")

    def __init__(self, rl, dl, starts, n: int):
        self.rl = rl  # ndarray | None (None = no repetition: all zeros)
        self.dl = dl  # ndarray | None (None = every entry at leaf max_def)
        self.starts = starts  # int64 slot-start positions | None (identity)
        self.n = n


def build_field_vec(schema, top, chunks: dict, mode: str):
    """The IR of one top-level field over one row group's leaf chunks.
    `top` is the schema node or its name; mode is "rows" | "raw" | "arrow".
    Returns (vec, n_rows). Raises VecStructureError on structures the scans
    cannot prove and AssemblyError on provable value-count corruption."""
    if isinstance(top, str):
        top = schema.column((top,))
    streams = {
        path: _Stream(schema.column(path), cd)
        for path, cd in chunks.items()
        if path[0] == top.name
    }
    if not streams:
        raise VecStructureError(f"no leaf chunks for field {top.name}")
    state = {}
    n_rows = None
    for path, ls in streams.items():
        if ls.rl is None:
            starts = None  # identity: entry i is record i
            count = ls.n
        else:
            if ls.n and int(ls.rl[0]) != 0:
                raise VecStructureError(f"{top.path_str}: stream opens mid-record")
            starts = rows_from_rep(ls.rl)
            count = len(starts)
        state[path] = _View(ls.rl, ls.dl, starts, ls.n)
        if n_rows is None:
            n_rows = count
        elif n_rows != count:
            raise VecStructureError(
                f"leaves of {top.name} disagree on row count "
                f"({n_rows} vs {count})"
            )
    if top.repetition == FieldRepetitionType.REPEATED:
        vec = _build_repeated(top, streams, state, n_rows, mode)
    else:
        vec = _build(top, streams, state, n_rows, mode)
    return vec, n_rows


def _sub_state(node, streams, state):
    sub = {p: st for p, st in state.items() if p[: len(node.path)] == node.path}
    if not sub:
        return None, None
    return sub, {p: streams[p] for p in sub}


def _build(node, streams, state, n_slots, mode):
    """IR of `node` over the current slots (node known present per slot
    except where its own null mask says otherwise)."""
    if node.repetition == FieldRepetitionType.REPEATED:
        # wire-shape repeated field (incl. spec-violating annotated repeated
        # groups: the annotation describes the node's content, but a
        # REPEATED node's slot granularity is its parent's)
        return _build_repeated(node, streams, state, n_slots, mode)

    if node.is_leaf:
        return _leaf_vec(node, streams, state, n_slots)

    if mode != "raw" and _is_map_node(node, mode) and len(node.children) == 1:
        kv = node.children[0]
        if (
            kv.repetition == FieldRepetitionType.REPEATED
            and not kv.is_leaf
            and len(kv.children) == 2
        ):
            null_mask = (
                _node_null_mask(node, state, n_slots)
                if node.repetition == FieldRepetitionType.OPTIONAL
                else None
            )
            offsets, elem_state = _expand(kv, state, n_slots)
            child = _build_struct(
                kv, streams, elem_state, int(offsets[-1]), mode, force_valid=True
            )
            # arrow needs both key and value selected for a MapArray; with
            # one projected out it assembles the underlying list-of-struct
            both = all(_covered(c, streams) for c in kv.children)
            kind = "list" if (mode == "arrow" and not both) else "map"
            return ListVec(node, kv, offsets, null_mask, child, kind)

    if mode != "raw" and _is_list_node(node, mode) and len(node.children) == 1:
        rep = node.children[0]
        if rep.repetition == FieldRepetitionType.REPEATED and (
            mode != "arrow" or not rep.is_leaf
        ):
            null_mask = (
                _node_null_mask(node, state, n_slots)
                if node.repetition == FieldRepetitionType.OPTIONAL
                else None
            )
            offsets, elem_state = _expand(rep, state, n_slots)
            n_elems = int(offsets[-1])
            if rep.is_leaf:
                # 2-level legacy list: the repeated leaf IS the element
                child = _leaf_vec(rep, streams, elem_state, n_elems)
            elif len(rep.children) == 1:
                sub_state, sub_streams = _sub_state(
                    rep.children[0], streams, elem_state
                )
                if sub_state is None:
                    raise VecStructureError(f"{node.path_str}: element projected out")
                child = _build(
                    rep.children[0], sub_streams, sub_state, n_elems, mode
                )
            else:
                child = _build_struct(
                    rep, streams, elem_state, n_elems, mode, force_valid=True
                )
            return ListVec(node, rep, offsets, null_mask, child, "list")

    return _build_struct(node, streams, state, n_slots, mode)


def _build_repeated(node, streams, state, n_slots, mode):
    """A wire-shape REPEATED field (legacy repeated leaf or group, or any
    repeated node in raw mode): a list of non-null instances per slot."""
    offsets, elem_state = _expand(node, state, n_slots)
    n_elems = int(offsets[-1])
    if node.is_leaf:
        child = _leaf_vec(node, streams, elem_state, n_elems)
    else:
        child = _build_struct(
            node, streams, elem_state, n_elems, mode, force_valid=True
        )
    return ListVec(node, node, offsets, None, child, "repeated")


def _build_struct(node, streams, state, n_slots, mode, force_valid=False):
    null_mask = None
    if not force_valid and node.repetition == FieldRepetitionType.OPTIONAL:
        null_mask = _node_null_mask(node, state, n_slots)
    names = []
    children = []
    for c in node.children:
        sub_state, sub_streams = _sub_state(c, streams, state)
        if sub_state is None:
            continue  # projected out
        names.append(c.name)
        children.append(_build(c, sub_streams, sub_state, n_slots, mode))
    if not names:
        raise VecStructureError(f"{node.path_str}: no selected leaf")
    return StructVec(node, names, children, null_mask, n_slots)


def _node_null_mask(node, state, n_slots):
    """Null mask over the current slots for an OPTIONAL node, from each
    slot's first entry's def level (shared above any descendant leaf, so
    any leaf serves). O(n_slots): slot starts are carried by the state."""
    if node.max_def <= 0:
        return None
    view = next(iter(state.values()))
    if view.dl is None:
        return None  # every entry fully defined: nothing can be null
    first_def = view.dl if view.starts is None else view.dl[view.starts]
    if len(first_def) != n_slots:
        raise VecStructureError(f"{node.path_str}: slot starts out of step")
    return validity_from_def(first_def, node.max_def)


def _expand(rep_node, state, n_slots):
    """Expand the current slots through one REPEATED node: (int64 offsets
    [n_slots+1], per-leaf element stream state). Every leaf under the node
    must describe the same list structure.

    An entry STARTS an element of this depth iff rep <= this depth AND
    def >= the element threshold (below it the entry is the placeholder of
    an empty/null list); per-slot counts are one prefix sum over that mask
    gathered at the slot boundaries — no searchsorted, no bincount. The
    element stream keeps the entries of the elements' subtrees
    (def >= threshold); its slot starts are the element-opening entries."""
    q = rep_node.max_rep
    d_r = rep_node.max_def
    offsets = None
    elem_state = {}
    for path, view in state.items():
        n = view.n
        # a missing rep stream widens to zeros: every entry its own
        # single-element list (the scalar walk's peek_rep() == 0)
        rl = view.rl if view.rl is not None else np.zeros(n, dtype=np.uint16)
        starts = view.starts
        if starts is None:
            starts = np.arange(n, dtype=np.int64)
        if view.dl is None:
            exists = None  # every entry fully defined: no placeholders
            m = rl <= q
        else:
            exists = view.dl >= d_r
            m = (rl <= q) & exists
        cs = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(m, out=cs[1:])
        if len(starts):
            counts = cs[np.append(starts[1:], n)] - cs[starts]
        else:
            counts = np.zeros(0, dtype=np.int64)
        offs = np.zeros(n_slots + 1, dtype=np.int64)
        np.cumsum(counts, out=offs[1:])
        if offsets is None:
            offsets = offs
        elif not np.array_equal(offsets, offs):
            raise VecStructureError(
                f"leaves under {rep_node.path_str} disagree on list structure"
            )
        if exists is None or bool(exists.all()):
            new_view = _View(rl, view.dl, None, n)
            kept_m = m
        else:
            new_view = _View(
                rl[exists], view.dl[exists], None, int(exists.sum())
            )
            kept_m = m[exists]
        elem_starts = np.flatnonzero(kept_m)
        if new_view.n and (not len(elem_starts) or elem_starts[0] != 0):
            # an entry extends an element before any opens: corrupt levels
            # (the scalar walk raises the precise error)
            raise VecStructureError(
                f"{rep_node.path_str}: inconsistent repetition levels"
            )
        new_view.starts = elem_starts
        elem_state[path] = new_view
    if offsets is None:
        raise VecStructureError(f"{rep_node.path_str}: no selected leaf")
    return offsets, elem_state


def _leaf_vec(leaf, streams, state, n_slots):
    ls = streams.get(leaf.path)
    if ls is None:
        raise VecStructureError(f"{leaf.path_str}: leaf not selected")
    view = state[leaf.path]
    if view.n != n_slots:
        raise VecStructureError(
            f"leaf {leaf.path_str} stream does not align with its slots "
            f"({view.n} entries for {n_slots} slots)"
        )
    if view.dl is None or leaf.max_def == 0:
        return LeafVec(leaf, ls.chunk, None, 0, n_slots, n_slots)
    valid = view.dl == leaf.max_def
    nv = int(valid.sum())
    if nv == n_slots:
        valid = None
    # k0 = 0 by the dense-slice invariant: entries dropped by list filters
    # above are never value-bearing, so the first kept value is value 0
    return LeafVec(leaf, ls.chunk, valid, 0, nv, n_slots)


# -- row materialization --------------------------------------------------------


def _leaf_column(vec: LeafVec, raw: bool) -> list:
    """Python value list (one per slot, None where null) for a LeafVec."""
    leaf, chunk = vec.node, vec.chunk
    tp = streams_present_count(chunk, leaf)
    total_present = chunk.num_values if tp is None else tp
    vals = _leaf_python_values(leaf, chunk, raw)
    if len(vals) != total_present:
        raise AssemblyError(
            f"assembly: {leaf.path_str}: {len(vals)} values for "
            f"{total_present} present entries"
        )
    if vec.k0 or vec.nv != len(vals):
        vals = vals[vec.k0 : vec.k0 + vec.nv]
    if vec.valid is None:
        return vals
    full = np.empty(vec.n, dtype=object)  # initialized to None
    full[vec.valid] = vals
    return full.tolist()


def streams_present_count(chunk, leaf):
    """Non-null cell count the chunk's def levels promise, or None when the
    leaf has no def dimension (count = num_values)."""
    if leaf.max_def > 0 and chunk.def_levels is not None:
        return int((np.asarray(chunk.def_levels) == leaf.max_def).sum())
    return None


def _apply_null_mask(values: list, null_mask) -> list:
    if null_mask is not None:
        for i in np.flatnonzero(null_mask).tolist():
            values[i] = None
    return values


def _column_from_vec(vec, raw: bool) -> list:
    """Materialize one IR node into a per-slot Python value list."""
    if isinstance(vec, LeafVec):
        return _leaf_column(vec, raw)

    if isinstance(vec, ListVec):
        if vec.kind == "map" and not raw:
            return _map_column(vec, raw)
        elems = _column_from_vec(vec.child, raw)
        return _rows_from_offsets(elems, vec.offsets, vec.null_mask)

    if isinstance(vec, StructVec):
        cols = [_column_from_vec(c, raw) for c in vec.children]
        rows = _zip_dict_rows(list(vec.names), cols)
        return _apply_null_mask(rows, vec.null_mask)

    raise TypeError(f"unknown vec node {type(vec).__name__}")


def _map_column(vec: ListVec, raw: bool):
    """MAP materialization: per-slot dicts from the kv struct's key/value
    columns (REQUIRED keys within a present entry; values may be null or
    projected out — p.get semantics, matching the scalar walk)."""
    kv = vec.rep_node
    n_elems = int(vec.offsets[-1])
    child = vec.child  # StructVec over the covered kv children
    by_name = dict(zip(child.names, child.children))
    cols = []
    for c in kv.children:
        sub = by_name.get(c.name)
        if sub is None:
            cols.append([None] * n_elems)
        else:
            cols.append(_column_from_vec(sub, raw))
    keys, vals = cols[0], cols[1]
    off = vec.offsets.tolist()
    mask = vec.null_mask.tolist() if vec.null_mask is not None else None
    kname, vname = kv.children[0].name, kv.children[1].name
    out = []
    for i, (a, b) in enumerate(zip(off[:-1], off[1:])):
        if mask is not None and mask[i]:
            out.append(None)
            continue
        try:
            out.append(dict(zip(keys[a:b], vals[a:b])))
        except TypeError:  # unhashable key: keep the pair list
            out.append(
                [{kname: k, vname: v} for k, v in zip(keys[a:b], vals[a:b])]
            )
    return out


def _rows_from_offsets(elems: list, offsets, null_mask) -> list:
    off = offsets.tolist()
    if null_mask is None:
        return [elems[a:b] for a, b in zip(off[:-1], off[1:])]
    return [
        None if m else elems[a:b]
        for m, a, b in zip(null_mask.tolist(), off[:-1], off[1:])
    ]


# -- flat fast path -------------------------------------------------------------


def _flat_column_values(node, chunk, raw: bool) -> list:
    """One flat leaf column as a row-aligned Python list (nulls expanded)."""
    vals = _leaf_python_values(node, chunk, raw)
    if node.max_def == 1 and chunk.def_levels is not None:
        mask = np.asarray(chunk.def_levels) == 1
        full = [None] * chunk.num_values
        it = iter(vals)
        for idx in np.nonzero(mask)[0]:
            full[idx] = next(it)
        vals = full
    return vals


def _flat_columns(chunks: dict, raw: bool):
    """(names, column value lists, n_rows) for flat schemas (no groups, no
    repetition) — per-column null-expansion at C speed via ndarray.tolist().
    None when the shape needs more than that."""
    cols = []
    for path, chunk in chunks.items():
        node = chunk.column
        if len(path) != 1 or not node.is_leaf or node.max_rep > 0 or node.max_def > 1:
            return None
        cols.append((node, chunk))
    n = None
    for _node, chunk in cols:
        if n is None:
            n = chunk.num_values
        elif n != chunk.num_values:
            return None
    if n is None:
        return [], [], 0
    names = [node.name for node, _ in cols]
    return names, [_flat_column_values(node, chunk, raw) for node, chunk in cols], n


# -- the engine entry points ----------------------------------------------------


def assemble_row_columns(schema, chunks: dict, raw: bool):
    """Column-oriented vectorized assembly: (names, columns, n_rows) where
    each column is a row-aligned value list — callers may window-slice
    columns to bound live row objects. None when the level streams describe a
    structure the scans cannot prove (the scalar RecordAssembler then
    decides — and raises its precise error if the data really is
    inconsistent)."""
    flat = _flat_columns(chunks, raw)
    if flat is not None:
        return flat
    by_top: dict[str, list] = {}
    for path in chunks:
        by_top.setdefault(path[0], []).append(path)
    mode = "raw" if raw else "rows"
    names = []
    columns = []
    n_rows = None
    try:
        for top in schema.root.children:
            paths = by_top.get(top.name)
            if not paths:
                continue  # not selected
            sub = {p: chunks[p] for p in paths}
            if top.is_leaf and top.max_rep == 0 and top.max_def <= 1:
                col = _flat_column_values(top, sub[paths[0]], raw)
                n = len(col)
            else:
                vec, n = build_field_vec(schema, top, sub, mode)
                col = _column_from_vec(vec, raw)
            if n_rows is None:
                n_rows = n
            elif n_rows != n:
                return None  # inconsistent; let the scalar walk raise precisely
            names.append(top.name)
            columns.append(col)
    except VecStructureError:
        return None
    if n_rows is None:
        return [], [], 0
    return names, columns, n_rows


def assemble_rows(schema, chunks: dict, raw: bool):
    """Row-list form of assemble_row_columns (None on unprovable shapes)."""
    rc = assemble_row_columns(schema, chunks, raw)
    if rc is None:
        return None
    names, columns, n = rc
    if not names or n == 0:
        return []
    return _zip_dict_rows(names, columns)


# -- shared row-zip machinery (consumed by the reader's windowed path) ----------


def _zip_dict_rows(names: list, columns: list) -> list:
    """Zip column value lists into row dicts."""
    return [dict(zip(names, row)) for row in zip(*columns)]


def slice_column(col, start: int, end: int):
    """Row-window of an assemble_row_columns column (list or slices spec).
    The port's assemble_row_columns yields lists only: the reference defers
    ("slices", elems, offsets, mask) specs to its C row-zip, which the port
    does not have. The spec form is kept so a window of either slices alike."""
    if isinstance(col, tuple):
        tag, elems, offsets, mask = col
        return (tag, elems, offsets[start : end + 1],
                None if mask is None else mask[start:end])
    return col[start:end]
