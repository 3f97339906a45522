"""Auto-schema: Python dataclasses / type hints -> parquet Schema.

A copy of parquet_tpu/floor/autoschema.py, over the port's schema builders
(schema/builder.py).
Equivalent of the reference's reflection-based generator (reference:
parquetschema/autoschema/gen.go:17-32 GenerateSchema, :60-387 generateField):
dataclass fields map to columns by type hint, Optional[...] controls
repetition, list/dict map to LIST/MAP groups, nested dataclasses to groups,
datetime types to DATE/TIME/TIMESTAMP logical types.

Mapping:
    int                 int64          float       double
    str                 binary(STRING) bytes       binary
    bool                boolean        np.int32    int32
    np.float32          float          np.int8/16  int32 (INT(8/16))
    datetime.datetime   int64 TIMESTAMP(MICROS, utc)
    datetime.date       int32 DATE
    datetime.time       int64 TIME(MICROS)
    Optional[T]         optional (else required)
    list[T]             LIST group     dict[K, V]  MAP group
    dataclass           nested group
Field name overrides via dataclasses metadata {"parquet": "name"}, the analogue
of the reference's struct tags (reference: floor/fieldname.go:8-19).
"""

from __future__ import annotations

import dataclasses
import datetime as dt

from .time import Time
import types
import typing

import numpy as np

from ..core.schema import Column, Schema
from ..meta.parquet_types import FieldRepetitionType, Type
from ..schema.builder import (
    _TypeSpec,
    _field,
    group,
    int_type,
    list_of,
    map_of,
    message,
    string,
    timestamp,
)
from ..meta.parquet_types import (
    ConvertedType,
    DateType,
    LogicalType,
    TimeType,
    TimeUnit,
)

__all__ = ["schema_from_dataclass", "AutoSchemaError"]


class AutoSchemaError(TypeError):
    pass


def _date_spec() -> _TypeSpec:
    return _TypeSpec(
        Type.INT32, converted=ConvertedType.DATE, logical=LogicalType(DATE=DateType())
    )


def _time_spec() -> _TypeSpec:
    return _TypeSpec(
        Type.INT64,
        converted=ConvertedType.TIME_MICROS,
        logical=LogicalType(
            TIME=TimeType(isAdjustedToUTC=True, unit=TimeUnit.micros())
        ),
    )


def _nanotime_spec() -> _TypeSpec:
    # floor.Time keeps nanosecond precision (reference: floor/time.go:10-13)
    return _TypeSpec(
        Type.INT64,
        logical=LogicalType(TIME=TimeType(isAdjustedToUTC=True, unit=TimeUnit.nanos())),
    )


_SCALARS = {
    int: lambda: Type.INT64,
    float: lambda: Type.DOUBLE,
    bool: lambda: Type.BOOLEAN,
    str: string,
    bytes: lambda: Type.BYTE_ARRAY,
    dt.datetime: lambda: timestamp("micros"),
    dt.date: _date_spec,
    dt.time: _time_spec,
    Time: _nanotime_spec,
    np.int64: lambda: Type.INT64,
    np.int32: lambda: Type.INT32,
    np.int16: lambda: int_type(16),
    np.int8: lambda: int_type(8),
    np.uint64: lambda: int_type(64, signed=False),
    np.uint32: lambda: int_type(32, signed=False),
    np.float64: lambda: Type.DOUBLE,
    np.float32: lambda: Type.FLOAT,
}


def schema_from_dataclass(cls, name: str | None = None) -> Schema:
    """Generate a Schema from a dataclass type."""
    if not dataclasses.is_dataclass(cls):
        raise AutoSchemaError(f"autoschema: {cls!r} is not a dataclass")
    fields = []
    hints = typing.get_type_hints(cls)
    for f in dataclasses.fields(cls):
        col_name = f.metadata.get("parquet", f.name) if f.metadata else f.name
        fields.append(_field_for(col_name, hints[f.name]))
    return message(*fields, name=name or cls.__name__.lower())


def _unwrap_optional(hint) -> tuple[object, bool]:
    origin = typing.get_origin(hint)
    if origin in (typing.Union, types.UnionType):
        args = [a for a in typing.get_args(hint) if a is not type(None)]
        if len(args) == 1 and len(typing.get_args(hint)) == 2:
            return args[0], True
        raise AutoSchemaError(f"autoschema: unsupported union {hint}")
    return hint, False


def _field_for(name: str, hint) -> Column:
    inner, is_opt = _unwrap_optional(hint)
    rep = FieldRepetitionType.OPTIONAL if is_opt else FieldRepetitionType.REQUIRED
    return _node_for(name, inner, rep)


def _node_for(name: str, hint, rep: FieldRepetitionType) -> Column:
    origin = typing.get_origin(hint)
    if origin in (list, typing.List):
        (elem_hint,) = typing.get_args(hint) or (int,)
        elem_inner, elem_opt = _unwrap_optional(elem_hint)
        elem = _node_for(
            "element",
            elem_inner,
            FieldRepetitionType.OPTIONAL if elem_opt else FieldRepetitionType.REQUIRED,
        )
        return list_of(name, elem, required_list=(rep == FieldRepetitionType.REQUIRED))
    if origin in (dict, typing.Dict):
        k_hint, v_hint = typing.get_args(hint) or (str, int)
        v_inner, v_opt = _unwrap_optional(v_hint)
        key = _node_for("key", k_hint, FieldRepetitionType.REQUIRED)
        value = _node_for(
            "value",
            v_inner,
            FieldRepetitionType.OPTIONAL if v_opt else FieldRepetitionType.REQUIRED,
        )
        return map_of(name, key, value, required_map=(rep == FieldRepetitionType.REQUIRED))
    if dataclasses.is_dataclass(hint):
        hints = typing.get_type_hints(hint)
        children = []
        for f in dataclasses.fields(hint):
            col_name = f.metadata.get("parquet", f.name) if f.metadata else f.name
            children.append(_field_for(col_name, hints[f.name]))
        return group(name, *children, repetition=rep)
    spec_fn = _SCALARS.get(hint)
    if spec_fn is None:
        raise AutoSchemaError(f"autoschema: unsupported type {hint!r} for field {name!r}")
    return _field(name, spec_fn(), rep)
