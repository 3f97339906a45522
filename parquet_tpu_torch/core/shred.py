"""Record shredding: nested rows -> per-leaf (value, def, rep) streams.

A copy of parquet_tpu/core/shred.py, except that add_row takes back a
failed row's entries (the reference leaves them). Write-side Dremel, the inverse of
assembly.py — the semantics of the reference's recursiveAddColumnData/
nil-propagation (reference: schema.go:837-891, :802-819) with one addition:
ergonomic input. The reference only accepts raw nested maps ({"list":
[{"element": v}]}); here LIST-annotated groups also accept plain Python lists
and MAP-annotated groups plain dicts, mirroring the reader's raw/ergonomic
duality.

The schema walk is COMPILED once per Shredder: each node becomes a closure
with its repetition kind, levels, annotation sugar, and leaf buffers bound as
locals, so the per-row hot path does no attribute lookups, enum compares, or
annotation checks (the interpreted walk measured 3x slower on nested rows).
"""

from __future__ import annotations

from ..meta.parquet_types import ConvertedType, FieldRepetitionType
from .schema import Column, Schema

__all__ = ["Shredder", "ShredError"]

_REPEATED = FieldRepetitionType.REPEATED
_REQUIRED = FieldRepetitionType.REQUIRED


class ShredError(ValueError):
    pass


def _value_size(v) -> int:
    """Approximate encoded size of one leaf value (reference: the per-type
    sizeOf of the typed stores, interfaces.go:67-81). Strings/bytes charge
    their real length — a flat per-value constant made string-heavy row
    groups overshoot the target size badly."""
    if isinstance(v, (str, bytes)):
        return len(v) + 4
    return 8


class _LeafBuffer:
    __slots__ = ("values", "def_levels", "rep_levels", "data_size")

    def __init__(self):
        self.values: list = []
        self.def_levels: list[int] = []
        self.rep_levels: list[int] = []
        self.data_size = 0  # approximate bytes of buffered values


class Shredder:
    """Accumulates shredded rows for all leaves of a schema."""

    def __init__(self, schema: Schema):
        self.schema = schema
        self.buffers: dict[tuple, _LeafBuffer] = {
            leaf.path: _LeafBuffer() for leaf in schema.leaves
        }
        self._bufs = list(self.buffers.values())
        self.num_rows = 0
        # buffer objects stay stable across drain() (lists rebind inside
        # them), so the compiled closures below never go stale
        self._fields = [
            (child.name, self._compile(child)) for child in schema.root.children
        ]

    def add_row(self, row: dict) -> None:
        """Append one row to every leaf, or to none: a row that raises part
        way through its fields has the entries it made taken back, so the
        leaves stay in step and the writer stays usable."""
        if not isinstance(row, dict):
            raise ShredError(f"shred: row must be a dict, got {type(row).__name__}")
        bufs = self._bufs
        marks = [len(b.values) for b in bufs]
        get = row.get
        try:
            for name, fn in self._fields:
                fn(get(name), 0, 0)
        except BaseException:
            for b, n in zip(bufs, marks):
                if len(b.values) > n:
                    # present values are never None; absent ones charged 0
                    b.data_size -= sum(_value_size(v) for v in b.values[n:] if v is not None)
                    del b.values[n:], b.def_levels[n:], b.rep_levels[n:]
            raise
        self.num_rows += 1

    # -- compilation (once per schema) -----------------------------------------

    def _compile(self, node: Column):
        """node -> fn(value, rep, parent_def) with everything prebound."""
        present = (
            self._compile_leaf(node) if node.is_leaf else self._compile_group(node)
        )
        nulls = self._compile_null(node)
        rep_kind = node.repetition
        path_str = node.path_str
        if rep_kind == _REPEATED:
            max_rep = node.max_rep

            def shred_repeated(
                value, rep, parent_def, present=present, nulls=nulls,
                max_rep=max_rep, path_str=path_str,
            ):
                if value is None:
                    nulls(rep, parent_def)
                    return
                if not isinstance(value, (list, tuple)):
                    raise ShredError(
                        f"shred: repeated field {path_str} expects a list, "
                        f"got {type(value).__name__}"
                    )
                if not value:
                    nulls(rep, parent_def)
                    return
                it = iter(value)
                present(next(it), rep)
                for item in it:  # no value[1:] copy on the hot path
                    present(item, max_rep)

            return shred_repeated
        if rep_kind == _REQUIRED:

            def shred_required(
                value, rep, parent_def, present=present, path_str=path_str
            ):
                if value is None:
                    raise ShredError(f"shred: required field {path_str} is None")
                present(value, rep)

            return shred_required

        def shred_optional(value, rep, parent_def, present=present, nulls=nulls):
            if value is None:
                nulls(rep, parent_def)
            else:
                present(value, rep)

        return shred_optional

    def _compile_leaf(self, node: Column):
        buf = self.buffers[node.path]
        max_def = node.max_def
        path_str = node.path_str

        def present_leaf(value, rep, buf=buf, max_def=max_def, path_str=path_str):
            if value is None:
                # Only reachable for REPEATED leaves: a bare repeated field
                # has no definition level to express a null element.
                raise ShredError(
                    f"shred: null element in repeated field {path_str} "
                    "(wrap the element in an optional group to store nulls)"
                )
            buf.values.append(value)
            # inlined _value_size (call elision on the hottest line); keep
            # the size model in sync with _value_size below
            buf.data_size += (
                len(value) + 4 if isinstance(value, (str, bytes)) else 8
            )
            buf.def_levels.append(max_def)
            buf.rep_levels.append(rep)

        return present_leaf

    def _compile_group(self, node: Column):
        children = [(c.name, self._compile(c)) for c in node.children]
        max_def = node.max_def
        path_str = node.path_str
        normalize = self._compile_normalize(node)

        def present_group(
            value, rep, children=children, max_def=max_def,
            normalize=normalize, path_str=path_str,
        ):
            if normalize is not None:
                value = normalize(value)
            if not isinstance(value, dict):
                raise ShredError(
                    f"shred: group {path_str} expects a dict, "
                    f"got {type(value).__name__}"
                )
            get = value.get
            for name, fn in children:
                fn(get(name), rep, max_def)

        return present_group

    def _compile_null(self, node: Column):
        """One absent entry for every leaf beneath `node`
        (reference: schema.go:802-819 nil-propagation)."""
        bufs: list[_LeafBuffer] = []
        self._collect_leaf_buffers(node, bufs)

        def nulls(rep, def_level, bufs=bufs):
            for buf in bufs:
                buf.values.append(None)
                buf.def_levels.append(def_level)
                buf.rep_levels.append(rep)

        return nulls

    def _collect_leaf_buffers(self, node: Column, out: list) -> None:
        if node.is_leaf:
            out.append(self.buffers[node.path])
            return
        for child in node.children:
            self._collect_leaf_buffers(child, out)

    def _compile_normalize(self, node: Column):
        """Ergonomic sugar, decided at compile time: LIST groups accept
        plain lists, MAP groups plain dicts; None for plain groups."""
        ct = node.converted_type
        lt = node.logical_type
        is_list = ct == ConvertedType.LIST or (lt is not None and lt.LIST is not None)
        is_map = ct in (ConvertedType.MAP, ConvertedType.MAP_KEY_VALUE) or (
            lt is not None and lt.MAP is not None
        )
        if is_list and len(node.children) == 1:
            mid = node.children[0]
            if mid.repetition == _REPEATED:
                mid_name = mid.name
                if mid.is_leaf or len(mid.children) != 1:

                    def norm_bare_list(value, mid_name=mid_name):
                        if isinstance(value, (list, tuple)):
                            return {mid_name: list(value)}
                        return value

                    return norm_bare_list
                elem_name = mid.children[0].name

                def norm_list(value, mid_name=mid_name, elem_name=elem_name):
                    if isinstance(value, (list, tuple)):
                        return {mid_name: [{elem_name: v} for v in value]}
                    return value

                return norm_list
        if is_map and len(node.children) == 1:
            kv = node.children[0]
            if (
                kv.repetition == _REPEATED
                and not kv.is_leaf
                and len(kv.children) == 2
            ):
                kv_name = kv.name
                kname = kv.children[0].name
                vname = kv.children[1].name

                def norm_map(value, kv_name=kv_name, kname=kname, vname=vname):
                    # Raw nested form is {"key_value": [...]} — require the
                    # value to be a list so a real map entry whose key
                    # happens to be "key_value" still takes this path.
                    if isinstance(value, dict) and not (
                        set(value.keys()) == {kv_name}
                        and isinstance(
                            value.get(kv_name), (list, tuple, type(None))
                        )
                    ):
                        return {
                            kv_name: [{kname: k, vname: v} for k, v in value.items()]
                        }
                    return value

                return norm_map
        return None

    # -- draining --------------------------------------------------------------

    def drain(self):
        """Return and reset the accumulated per-leaf buffers (the buffer
        OBJECTS persist — compiled closures hold them)."""
        out = {}
        for path, b in self.buffers.items():
            out[path] = (b.values, b.def_levels, b.rep_levels)
            b.values = []
            b.def_levels = []
            b.rep_levels = []
            b.data_size = 0
        n = self.num_rows
        self.num_rows = 0
        return out, n
