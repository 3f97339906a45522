"""One query unit's filtered rows on the host, for the host query engine.

The port's counterpart of the pyarrow table the reference's query units
aggregate: FileReader.to_arrow(row_groups=[i], columns=, filters=) of
parquet_tpu/core/reader.py. A unit table holds the rows of one row group
that survive the residual filter, for the projected columns, as the host
decode delivers them (FileReader._read_row_group(pack=False)):

  * a flat leaf or a struct field (no repeated node on its path) is its
    dense values (the valid rows' physical values: a NumPy array, 2-D
    uint8 rows for FIXED_LEN_BYTE_ARRAY and INT96, or ByteArrayData) and
    a validity mask over the kept rows (None: every row valid). A field's
    row is null where the struct above it is, as pc.struct_field sees it;
  * a group, a LIST / MAP, or a repeated node carries its validity only,
    which count reads: a row's node is null where the definition level of
    the row's first entry stops above the node.

The filter is the reference's filtered read (_to_arrow_filtered): a group
the statistics or bloom filters exclude has no rows, a vacuous DNF keeps
every row, and the mask is core/filter_vec.dnf_mask with pyarrow's null
convention (null_mode="arrow": a comparison with null drops the row,
not_in keeps it). Filter columns outside the projection apply and are not
kept. A group quarantined under on_error= has no rows, as the reference's
zero-row table. The reference's table of one group has one chunk a
column, so a float sum over it is one chunk's (serve/aggregate).
"""

from __future__ import annotations

import numpy as np

from ..meta.parquet_types import ConvertedType, FieldRepetitionType, Type
from .arrays import ByteArrayData

__all__ = ["HostColumn", "HostUnitTable", "list_like"]


class HostColumn:
    """One column of a unit table over its kept rows. `values` is None for
    a node that is not a flat leaf (its validity is all it has)."""

    __slots__ = ("node", "values", "valid", "num_rows")

    def __init__(self, node, values, valid, num_rows: int):
        self.node = node
        self.values = values
        self.valid = valid
        self.num_rows = num_rows

    @property
    def null_count(self) -> int:
        return 0 if self.valid is None else self.num_rows - int(self.valid.sum())


def list_like(node) -> bool:
    """True when the node reads as an arrow list: a LIST or MAP annotated
    group, or a repeated node."""
    if node.repetition == FieldRepetitionType.REPEATED:
        return True
    ct = node.converted_type
    lt = node.logical_type
    if ct in (ConvertedType.LIST, ConvertedType.MAP, ConvertedType.MAP_KEY_VALUE):
        return True
    return lt is not None and (lt.LIST is not None or lt.MAP is not None)


def _take(values, keep: np.ndarray):
    if isinstance(values, ByteArrayData):
        return values.take(np.flatnonzero(keep))
    return values[keep]


class HostUnitTable:
    """The kept rows of one row group: `num_rows`, and `column(path)` for
    a projected node (its first name among `tops`, the projection's top
    level names). `mask` is the filter's bool[n] row mask over the group's
    rows, None when every row is kept."""

    def __init__(self, schema, tops, chunks: dict, num_rows: int, mask=None):
        self.schema = schema
        self.tops = frozenset(tops)
        self.num_rows = num_rows
        self._chunks = chunks
        self._mask = mask
        self._cache: dict = {}

    def column(self, path: tuple) -> HostColumn:
        """The node at `path` over the kept rows. KeyError when its top name
        is not projected."""
        if path[0] not in self.tops:
            raise KeyError(path[0])
        col = self._cache.get(path)
        if col is None:
            col = self._cache[path] = self._build(self.schema.column(path))
        return col

    def _build(self, node) -> HostColumn:
        if not self._chunks:
            # no rows (pruned, quarantined or empty): nothing to decode
            return HostColumn(node, _empty_values(node), None, 0)
        mask = self._mask
        if node.is_leaf and node.max_rep == 0:
            cd = self._chunks[node.path]
            valid = None
            if node.max_def > 0 and cd.def_levels is not None:
                v = np.asarray(cd.def_levels) == node.max_def
                if not v.all():
                    valid = v
            values = cd.values
            if mask is not None:
                values = _take(values, mask if valid is None else mask[valid])
                valid = None if valid is None else valid[mask]
            return HostColumn(node, values, valid, self.num_rows)
        return HostColumn(node, None, self._node_valid(node), self.num_rows)

    def _node_valid(self, node):
        """Row validity of a group or repeated node, from the levels of the
        first decoded leaf under it at each row's first entry."""
        leaf = next(
            c for c in self.schema.leaves
            if c.path[: len(node.path)] == node.path and c.path in self._chunks
        )
        cd = self._chunks[leaf.path]
        if cd.def_levels is None:
            return None
        dl = np.asarray(cd.def_levels)
        if cd.rep_levels is not None:
            dl = dl[np.asarray(cd.rep_levels) == 0]
        # the definition level at which the node is present: its optional
        # ancestors and itself, where a repeated node (an arrow list) is
        # present whenever its parent is
        need = node.max_def - (1 if node.repetition == FieldRepetitionType.REPEATED else 0)
        valid = dl >= need
        if self._mask is not None:
            valid = valid[self._mask]
        return None if valid.all() else valid


def _empty_values(node):
    if not node.is_leaf or node.max_rep != 0:
        return None
    t = node.type
    if t == Type.BYTE_ARRAY:
        return ByteArrayData(offsets=np.zeros(1, dtype=np.int64), data=b"")
    if t in (Type.FIXED_LEN_BYTE_ARRAY, Type.INT96):
        return np.zeros((0, 12 if t == Type.INT96 else node.type_length or 0), dtype=np.uint8)
    return np.zeros(0, dtype={
        Type.INT32: np.int32, Type.INT64: np.int64, Type.FLOAT: np.float32,
        Type.DOUBLE: np.float64, Type.BOOLEAN: np.bool_,
    }[t])
