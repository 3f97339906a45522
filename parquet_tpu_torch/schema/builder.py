"""Programmatic schema construction.

A copy of parquet_tpu/schema/builder.py, the reference's public schema
builders (reference: schema.go:572-647 NewDataColumn/NewListColumn/
NewMapColumn, ColumnParameters :561-568): compose the port's Column trees
without writing DSL text.

    schema = message(
        required("id", Type.INT64),
        optional("name", string()),
        list_of("tags", optional_elem=optional("element", string())),
        map_of("attrs", key=required("key", string()),
                        value=optional("value", Type.INT32)),
    )
"""

from __future__ import annotations

from ..core.schema import Column, Schema
from ..meta.parquet_types import (
    ConvertedType,
    DateType,
    DecimalType,
    FieldRepetitionType,
    IntType,
    ListType,
    LogicalType,
    MapType,
    SchemaElement,
    StringType,
    TimestampType,
    TimeType,
    TimeUnit,
    Type,
)

__all__ = [
    "message",
    "required",
    "optional",
    "repeated",
    "group",
    "list_of",
    "map_of",
    "string",
    "timestamp",
    "date",
    "time_of_day",
    "decimal",
    "int_type",
]


class _TypeSpec:
    """Physical type + annotations bundle usable in place of a bare Type."""

    def __init__(self, ptype: Type, converted=None, logical=None, type_length=None,
                 scale=None, precision=None):
        self.ptype = ptype
        self.converted = converted
        self.logical = logical
        self.type_length = type_length
        self.scale = scale
        self.precision = precision


def string() -> _TypeSpec:
    return _TypeSpec(
        Type.BYTE_ARRAY,
        converted=ConvertedType.UTF8,
        logical=LogicalType(STRING=StringType()),
    )


_TIME_UNITS = {"millis": TimeUnit.millis, "micros": TimeUnit.micros, "nanos": TimeUnit.nanos}


def _unit(unit: str):
    if unit not in _TIME_UNITS:
        raise ValueError(f"bad time unit {unit!r} (millis/micros/nanos)")
    return _TIME_UNITS[unit]


def timestamp(unit: str = "micros", utc: bool = True) -> _TypeSpec:
    u = _unit(unit)
    conv = {
        "millis": ConvertedType.TIMESTAMP_MILLIS,
        "micros": ConvertedType.TIMESTAMP_MICROS,
        "nanos": None,
    }[unit]
    return _TypeSpec(
        Type.INT64,
        converted=conv,
        logical=LogicalType(
            TIMESTAMP=TimestampType(isAdjustedToUTC=utc, unit=u())
        ),
    )


def date() -> _TypeSpec:
    return _TypeSpec(
        Type.INT32,
        converted=ConvertedType.DATE,
        logical=LogicalType(DATE=DateType()),
    )


def time_of_day(unit: str = "micros", utc: bool = True) -> _TypeSpec:
    u = _unit(unit)
    conv = {
        "millis": ConvertedType.TIME_MILLIS,
        "micros": ConvertedType.TIME_MICROS,
        "nanos": None,
    }[unit]
    return _TypeSpec(
        Type.INT32 if unit == "millis" else Type.INT64,
        converted=conv,
        logical=LogicalType(TIME=TimeType(isAdjustedToUTC=utc, unit=u())),
    )


def decimal(precision: int, scale: int = 0, fixed_width: int | None = None) -> _TypeSpec:
    """DECIMAL over the narrowest standard storage (INT32 to precision 9,
    INT64 to 18, FLBA beyond — or `fixed_width` to force FLBA)."""
    if not 1 <= precision or not 0 <= scale <= precision:
        raise ValueError("decimal: need precision >= 1 and 0 <= scale <= precision")
    min_width = 1
    while 10 ** precision > 1 << (8 * min_width - 1):
        min_width += 1
    if fixed_width is not None:
        if fixed_width < min_width:
            raise ValueError(
                f"decimal: fixed_width {fixed_width} cannot hold precision "
                f"{precision} (needs >= {min_width} bytes)"
            )
        ptype, tl = Type.FIXED_LEN_BYTE_ARRAY, fixed_width
    elif precision <= 9:
        ptype, tl = Type.INT32, None
    elif precision <= 18:
        ptype, tl = Type.INT64, None
    else:
        ptype, tl = Type.FIXED_LEN_BYTE_ARRAY, min_width
    return _TypeSpec(
        ptype,
        converted=ConvertedType.DECIMAL,
        logical=LogicalType(DECIMAL=DecimalType(scale=scale, precision=precision)),
        type_length=tl,
        scale=scale,
        precision=precision,
    )


def int_type(bits: int, signed: bool = True) -> _TypeSpec:
    ptype = Type.INT64 if bits == 64 else Type.INT32
    conv_name = f"{'INT' if signed else 'UINT'}_{bits}"
    return _TypeSpec(
        ptype,
        converted=ConvertedType[conv_name],
        logical=LogicalType(INTEGER=IntType(bitWidth=bits, isSigned=signed)),
    )


def _clone_column(col: Column) -> Column:
    """Deep-copy a Column so builder helpers never mutate caller objects."""
    elem = SchemaElement(
        **{
            fname: getattr(col.element, fname)
            for fname, _ft, _spec in SchemaElement.FIELDS.values()
        }
    )
    return Column(element=elem, children=[_clone_column(c) for c in col.children])


def _field(name: str, spec, repetition: FieldRepetitionType) -> Column:
    if isinstance(spec, Column):
        # wrap a copy of an existing group/leaf with a new name/repetition
        spec = _clone_column(spec)
        spec.element.name = name
        spec.element.repetition_type = int(repetition)
        return spec
    if isinstance(spec, Type):
        spec = _TypeSpec(spec)
    elem = SchemaElement(
        type=int(spec.ptype),
        name=name,
        repetition_type=int(repetition),
        converted_type=int(spec.converted) if spec.converted is not None else None,
        logicalType=spec.logical,
        type_length=spec.type_length,
        scale=spec.scale,
        precision=spec.precision,
    )
    return Column(element=elem)


def required(name: str, spec) -> Column:
    return _field(name, spec, FieldRepetitionType.REQUIRED)


def optional(name: str, spec) -> Column:
    return _field(name, spec, FieldRepetitionType.OPTIONAL)


def repeated(name: str, spec) -> Column:
    return _field(name, spec, FieldRepetitionType.REPEATED)


def group(name: str, *children: Column, repetition=FieldRepetitionType.OPTIONAL,
          converted=None, logical=None) -> Column:
    elem = SchemaElement(
        name=name,
        repetition_type=int(repetition),
        num_children=len(children),
        converted_type=int(converted) if converted is not None else None,
        logicalType=logical,
    )
    return Column(element=elem, children=list(children))


def list_of(name: str, element: Column, required_list: bool = False) -> Column:
    """Standard 3-level LIST: <name> (LIST) { repeated group list { element } }."""
    element = _clone_column(element)
    element.element.name = "element"
    mid = group("list", element, repetition=FieldRepetitionType.REPEATED)
    return group(
        name,
        mid,
        repetition=(
            FieldRepetitionType.REQUIRED if required_list else FieldRepetitionType.OPTIONAL
        ),
        converted=ConvertedType.LIST,
        logical=LogicalType(LIST=ListType()),
    )


def map_of(name: str, key: Column, value: Column, required_map: bool = False) -> Column:
    key = _clone_column(key)
    value = _clone_column(value)
    key.element.name = "key"
    key.element.repetition_type = int(FieldRepetitionType.REQUIRED)
    value.element.name = "value"
    kv = group("key_value", key, value, repetition=FieldRepetitionType.REPEATED,
               converted=ConvertedType.MAP_KEY_VALUE)
    return group(
        name,
        kv,
        repetition=(
            FieldRepetitionType.REQUIRED if required_map else FieldRepetitionType.OPTIONAL
        ),
        converted=ConvertedType.MAP,
        logical=LogicalType(MAP=MapType()),
    )


def message(*fields: Column, name: str = "schema") -> Schema:
    root = Column(
        element=SchemaElement(name=name, num_children=len(fields)),
        children=list(fields),
    )
    return Schema(root)
