"""Schema tree: Column nodes with max repetition/definition levels.

The dual-use (reader+writer) schema model of the reference (reference:
schema.go — Column tree, recursiveFix at :667-693, Thrift flattening/parsing at
:893-1015), minus the per-column value stores: in this design decoded data
lives in typed arrays keyed by column path, not inside the tree.

Level rules (Dremel): walking from the root, OPTIONAL or REPEATED increments
max_def; REPEATED also increments max_rep. The root is not counted.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from functools import cached_property

from ..meta.parquet_types import (
    ConvertedType,
    FieldRepetitionType,
    LogicalType,
    SchemaElement,
    Type,
)

__all__ = ["Column", "Schema", "SchemaError"]


class SchemaError(ValueError):
    pass


@dataclass
class Column:
    """A node in the schema tree (group or leaf)."""

    element: SchemaElement
    children: list["Column"] = field(default_factory=list)
    path: tuple[str, ...] = ()
    max_def: int = 0
    max_rep: int = 0
    leaf_index: int = -1  # position among leaves, -1 for groups

    @property
    def name(self) -> str:
        return self.element.name

    @property
    def is_leaf(self) -> bool:
        return not self.children

    # type/repetition/converted_type are cached: enum construction per call
    # is measurable on the per-page paths. Schema elements are never mutated
    # after a tree is built, so a cache never goes stale.
    @cached_property
    def type(self) -> Type | None:
        return Type(self.element.type) if self.element.type is not None else None

    @property
    def type_length(self) -> int | None:
        return self.element.type_length

    @cached_property
    def repetition(self) -> FieldRepetitionType:
        rt = self.element.repetition_type
        return FieldRepetitionType(rt if rt is not None else 0)

    @cached_property
    def converted_type(self) -> ConvertedType | None:
        ct = self.element.converted_type
        return ConvertedType(ct) if ct is not None else None

    @property
    def logical_type(self) -> LogicalType | None:
        return self.element.logicalType

    @property
    def path_str(self) -> str:
        return ".".join(self.path)

    def is_string(self) -> bool:
        """UTF8 annotation (converted or logical)."""
        if self.converted_type == ConvertedType.UTF8:
            return True
        lt = self.logical_type
        return lt is not None and lt.STRING is not None

    def __repr__(self):
        kind = self.type.name if self.is_leaf and self.type is not None else "group"
        return (
            f"Column({self.path_str or '<root>'}: {kind}, "
            f"{self.repetition.name}, maxR={self.max_rep}, maxD={self.max_def})"
        )


def _deep_copy_column(col: Column) -> Column:
    # deepcopy the element so nested structs (logicalType) are independent too
    elem = copy.deepcopy(col.element)
    return Column(element=elem, children=[_deep_copy_column(c) for c in col.children])


class Schema:
    """Parsed schema: root group + flat leaf list in file order."""

    def __init__(self, root: Column):
        self.root = root
        self.leaves: list[Column] = []
        self._by_path: dict[tuple[str, ...], Column] = {}
        self._finalize(root, 0, 0)

    def _finalize(self, node: Column, max_def: int, max_rep: int) -> None:
        for child in node.children:
            d, r = max_def, max_rep
            rep = child.repetition
            if rep in (FieldRepetitionType.OPTIONAL, FieldRepetitionType.REPEATED):
                d += 1
            if rep == FieldRepetitionType.REPEATED:
                r += 1
            child.max_def = d
            child.max_rep = r
            child.path = node.path + (child.name,)
            self._by_path[child.path] = child
            if child.is_leaf:
                child.leaf_index = len(self.leaves)
                self.leaves.append(child)
            else:
                self._finalize(child, d, r)

    # -- lookup ----------------------------------------------------------------

    def column(self, path) -> Column:
        """Find a node by tuple path or dotted string."""
        if isinstance(path, str):
            path = tuple(path.split("."))
        node = self._by_path.get(tuple(path))
        if node is None:
            raise SchemaError(f"schema: no column {'.'.join(path)}")
        return node

    def sub_schema(self, path) -> "Schema":
        """A new Schema rooted at the named group — the reference's
        SchemaDefinition.SubSchema (schema_def.go:137-150)."""
        node = self.column(path)
        if node.is_leaf:
            raise SchemaError(
                f"schema: sub_schema root {node.path_str!r} is a leaf, not a group"
            )
        return Schema(_deep_copy_column(node))

    def clone(self) -> "Schema":
        """Independent deep copy — the reference's SchemaDefinition.Clone
        (schema_def.go:106-112, which round-trips through the printer; here a
        structural copy, equivalent and cheaper)."""
        return Schema(_deep_copy_column(self.root))

    # -- thrift conversion -----------------------------------------------------

    @classmethod
    def from_thrift(cls, elements: list[SchemaElement]) -> "Schema":
        """Parse the depth-first-flattened element list of a footer
        (reference: schema.go:992 readSchema)."""
        if not elements:
            raise SchemaError("schema: empty element list")
        pos = 0

        def read_node(elem: SchemaElement) -> Column:
            nonlocal pos
            node = Column(element=elem)
            n = elem.num_children or 0
            if n < 0:
                raise SchemaError(f"schema: element {elem.name!r} claims {n} children")
            if n == 0 and elem.type is None:
                raise SchemaError(f"schema: group {elem.name!r} has no children and no type")
            for _ in range(n):
                # Re-check per child: earlier siblings' subtrees consume elements.
                if pos >= len(elements):
                    raise SchemaError(
                        f"schema: element {elem.name!r} claims {n} children "
                        "but the element list is exhausted"
                    )
                child_elem = elements[pos]
                pos += 1
                node.children.append(read_node(child_elem))
            return node

        root_elem = elements[0]
        pos = 1
        root = Column(element=root_elem)
        n = root_elem.num_children or 0
        if n <= 0:
            raise SchemaError("schema: root must have children")
        for _ in range(n):
            if pos >= len(elements):
                raise SchemaError("schema: truncated element list")
            child = elements[pos]
            pos += 1
            root.children.append(read_node(child))
        if pos != len(elements):
            raise SchemaError(
                f"schema: {len(elements) - pos} trailing elements after tree"
            )
        return cls(root)

    def to_thrift(self) -> list[SchemaElement]:
        out: list[SchemaElement] = []

        def emit(node: Column) -> None:
            out.append(node.element)
            for c in node.children:
                emit(c)

        root = self.root.element
        root.num_children = len(self.root.children)
        out.append(root)
        for c in self.root.children:
            emit(c)
        return out

    def __repr__(self):
        return f"Schema({len(self.leaves)} leaves)"
