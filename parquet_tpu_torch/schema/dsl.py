"""Textual schema DSL: parser, printer, validator.

A copy of parquet_tpu/schema/dsl.py (reference: parquetschema/schema_parser.go
— lexer :98-257, parser :314-729, validator :734-955; grammar documented at
schema_def.go:33-93), building the port's own core.schema Schema and Column.
Same grammar:

    message <name> {
      <repetition> <type> <name> [(ANNOTATION[(args)])] [= <field id>];
      <repetition> group <name> [(LIST|MAP)] { ... }
    }

Types: boolean int32 int64 int96 float double binary fixed_len_byte_array(N).
Annotations: STRING ENUM UUID JSON BSON DATE MAP LIST MAP_KEY_VALUE INTERVAL,
DECIMAL(p[,s]), TIME(MILLIS|MICROS|NANOS, true|false),
TIMESTAMP(MILLIS|MICROS|NANOS, true|false), INT(8|16|32|64, true|false), plus
the legacy converted-type spellings (UTF8, TIME_MILLIS, TIMESTAMP_MICROS,
UINT_8..INT_64, ...).

parse_schema() -> Schema (the Schema FileReader and FileWriter use);
schema_to_string() round-trips (reference: schema_def.go:114-132 String()).
Validation: structural checks during parse; validate()/validate_strict() add
LIST/MAP/TIME/DECIMAL convention checks with the reference's lenient mode
accepting Athena's `bag`/`array_element` forms (schema_parser.go:776-833).
"""

from __future__ import annotations

import re

from ..core.schema import Column, Schema, SchemaError
from ..meta.parquet_types import (
    ConvertedType,
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
    BsonType,
    DateType,
    EnumType,
    Float16Type,
    JsonType,
    UUIDType,
)

__all__ = ["parse_schema", "schema_to_string", "SchemaParseError", "validate", "validate_strict"]


class SchemaParseError(ValueError):
    pass


_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<punct>[{}();=,])
  | (?P<num>-?\d+)
  | (?P<ident>[A-Za-z_][A-Za-z0-9_.\-]*)
    """,
    re.VERBOSE,
)

_PHYSICAL = {
    "boolean": Type.BOOLEAN,
    "int32": Type.INT32,
    "int64": Type.INT64,
    "int96": Type.INT96,
    "float": Type.FLOAT,
    "double": Type.DOUBLE,
    "binary": Type.BYTE_ARRAY,
    "fixed_len_byte_array": Type.FIXED_LEN_BYTE_ARRAY,
}

_REPETITION = {
    "required": FieldRepetitionType.REQUIRED,
    "optional": FieldRepetitionType.OPTIONAL,
    "repeated": FieldRepetitionType.REPEATED,
}

# Simple (argument-free) annotations -> (converted type, logical ctor)
_SIMPLE_ANNOTATIONS = {
    "STRING": (ConvertedType.UTF8, lambda: LogicalType(STRING=StringType())),
    "UTF8": (ConvertedType.UTF8, lambda: LogicalType(STRING=StringType())),
    "ENUM": (ConvertedType.ENUM, lambda: LogicalType(ENUM=EnumType())),
    "JSON": (ConvertedType.JSON, lambda: LogicalType(JSON=JsonType())),
    "BSON": (ConvertedType.BSON, lambda: LogicalType(BSON=BsonType())),
    "DATE": (ConvertedType.DATE, lambda: LogicalType(DATE=DateType())),
    "UUID": (None, lambda: LogicalType(UUID=UUIDType())),
    "FLOAT16": (None, lambda: LogicalType(FLOAT16=Float16Type())),
    "MAP": (ConvertedType.MAP, lambda: LogicalType(MAP=MapType())),
    "LIST": (ConvertedType.LIST, lambda: LogicalType(LIST=ListType())),
    "MAP_KEY_VALUE": (ConvertedType.MAP_KEY_VALUE, lambda: None),
    "INTERVAL": (ConvertedType.INTERVAL, lambda: None),
    "TIME_MILLIS": (ConvertedType.TIME_MILLIS,
                    lambda: LogicalType(TIME=TimeType(isAdjustedToUTC=True, unit=TimeUnit.millis()))),
    "TIME_MICROS": (ConvertedType.TIME_MICROS,
                    lambda: LogicalType(TIME=TimeType(isAdjustedToUTC=True, unit=TimeUnit.micros()))),
    "TIMESTAMP_MILLIS": (ConvertedType.TIMESTAMP_MILLIS,
                         lambda: LogicalType(TIMESTAMP=TimestampType(isAdjustedToUTC=True, unit=TimeUnit.millis()))),
    "TIMESTAMP_MICROS": (ConvertedType.TIMESTAMP_MICROS,
                         lambda: LogicalType(TIMESTAMP=TimestampType(isAdjustedToUTC=True, unit=TimeUnit.micros()))),
}
for _bits in (8, 16, 32, 64):
    for _sign, _prefix in ((True, "INT"), (False, "UINT")):
        _SIMPLE_ANNOTATIONS[f"{_prefix}_{_bits}"] = (
            ConvertedType[f"{_prefix}_{_bits}"],
            (lambda b, s: (lambda: LogicalType(INTEGER=IntType(bitWidth=b, isSigned=s))))(_bits, _sign),
        )


class _Tokens:
    def __init__(self, text: str):
        self.tokens: list[tuple[str, str, int]] = []  # (kind, value, line)
        line = 1
        pos = 0
        while pos < len(text):
            m = _TOKEN_RE.match(text, pos)
            if not m:
                raise SchemaParseError(
                    f"schema: unexpected character {text[pos]!r} at line {line}"
                )
            kind = m.lastgroup
            value = m.group()
            if kind == "ws":
                line += value.count("\n")
            else:
                self.tokens.append((kind, value, line))
            pos = m.end()
        self.i = 0

    def peek(self):
        return self.tokens[self.i] if self.i < len(self.tokens) else ("eof", "", -1)

    def next(self):
        t = self.peek()
        self.i += 1
        return t

    def expect(self, value=None, kind=None):
        k, v, line = self.next()
        if value is not None and v != value:
            raise SchemaParseError(f"schema: expected {value!r}, got {v!r} at line {line}")
        if kind is not None and k != kind:
            raise SchemaParseError(f"schema: expected {kind}, got {v!r} at line {line}")
        return v

    def accept(self, value) -> bool:
        if self.peek()[1] == value:
            self.i += 1
            return True
        return False


def parse_schema(text: str) -> Schema:
    """Parse DSL text into a Schema (reference: ParseSchemaDefinition)."""
    toks = _Tokens(text)
    kw = toks.expect(kind="ident")
    if kw != "message":
        raise SchemaParseError(f"schema: expected 'message', got {kw!r}")
    name = toks.expect(kind="ident")
    toks.expect("{")
    children = _parse_group_body(toks)
    if toks.peek()[0] != "eof":
        k, v, line = toks.peek()
        raise SchemaParseError(f"schema: trailing content {v!r} at line {line}")
    root = Column(
        element=SchemaElement(name=name, num_children=len(children)),
        children=children,
    )
    return Schema(root)


def _parse_group_body(toks: _Tokens) -> list[Column]:
    children = []
    while not toks.accept("}"):
        children.append(_parse_field(toks))
    return children


def _parse_field(toks: _Tokens) -> Column:
    k, v, line = toks.next()
    rep = _REPETITION.get(v)
    if rep is None:
        raise SchemaParseError(
            f"schema: expected repetition (required/optional/repeated), got {v!r} at line {line}"
        )
    k, v, line = toks.next()
    if v == "group":
        name = toks.expect(kind="ident")
        converted = None
        logical = None
        if toks.accept("("):
            converted, logical, _, _ = _parse_annotation(toks)
        field_id = _parse_field_id(toks)
        toks.expect("{")
        children = _parse_group_body(toks)
        if not children:
            raise SchemaParseError(f"schema: group {name!r} has no children")
        elem = SchemaElement(
            name=name,
            repetition_type=int(rep),
            num_children=len(children),
            converted_type=int(converted) if converted is not None else None,
            logicalType=logical,
            field_id=field_id,
        )
        return Column(element=elem, children=children)
    ptype = _PHYSICAL.get(v)
    if ptype is None:
        raise SchemaParseError(f"schema: unknown type {v!r} at line {line}")
    type_length = None
    if ptype == Type.FIXED_LEN_BYTE_ARRAY:
        toks.expect("(")
        type_length = int(toks.expect(kind="num"))
        toks.expect(")")
        if type_length <= 0:
            raise SchemaParseError(f"schema: invalid fixed length {type_length}")
    name = toks.expect(kind="ident")
    converted = logical = None
    scale = precision = None
    if toks.accept("("):
        converted, logical, scale, precision = _parse_annotation(toks)
    field_id = _parse_field_id(toks)
    toks.expect(";")
    elem = SchemaElement(
        type=int(ptype),
        type_length=type_length,
        name=name,
        repetition_type=int(rep),
        converted_type=int(converted) if converted is not None else None,
        logicalType=logical,
        scale=scale,
        precision=precision,
        field_id=field_id,
    )
    return Column(element=elem)


def _parse_field_id(toks: _Tokens):
    if toks.accept("="):
        return int(toks.expect(kind="num"))
    return None


def _parse_annotation(toks: _Tokens):
    """Inside '(...)': returns (converted, logical, scale, precision)."""
    k, v, line = toks.next()
    upper = v.upper()
    if upper in _SIMPLE_ANNOTATIONS:
        conv, mk = _SIMPLE_ANNOTATIONS[upper]
        toks.expect(")")
        return conv, mk(), None, None
    if upper == "DECIMAL":
        precision = scale = None
        if toks.accept("("):
            precision = int(toks.expect(kind="num"))
            if toks.accept(","):
                scale = int(toks.expect(kind="num"))
            toks.expect(")")
        toks.expect(")")
        scale = scale or 0
        if precision is None or precision <= 0:
            raise SchemaParseError(f"schema: DECIMAL needs positive precision at line {line}")
        if scale < 0 or scale > precision:
            raise SchemaParseError(
                f"schema: DECIMAL scale {scale} out of range for precision {precision}"
            )
        lt = LogicalType(DECIMAL=DecimalType(scale=scale, precision=precision))
        return ConvertedType.DECIMAL, lt, scale, precision
    if upper in ("TIME", "TIMESTAMP"):
        toks.expect("(")
        unit_name = toks.expect(kind="ident").upper()
        units = {"MILLIS": TimeUnit.millis, "MICROS": TimeUnit.micros, "NANOS": TimeUnit.nanos}
        if unit_name not in units:
            raise SchemaParseError(f"schema: bad {upper} unit {unit_name} at line {line}")
        toks.expect(",")
        utc_tok = toks.expect(kind="ident")
        if utc_tok not in ("true", "false"):
            raise SchemaParseError(f"schema: bad utc flag {utc_tok!r} at line {line}")
        utc = utc_tok == "true"
        toks.expect(")")
        toks.expect(")")
        unit = units[unit_name]()
        if upper == "TIME":
            conv = {
                "MILLIS": ConvertedType.TIME_MILLIS,
                "MICROS": ConvertedType.TIME_MICROS,
                "NANOS": None,
            }[unit_name] if utc else None
            return conv, LogicalType(TIME=TimeType(isAdjustedToUTC=utc, unit=unit)), None, None
        conv = {
            "MILLIS": ConvertedType.TIMESTAMP_MILLIS,
            "MICROS": ConvertedType.TIMESTAMP_MICROS,
            "NANOS": None,
        }[unit_name] if utc else None
        return conv, LogicalType(TIMESTAMP=TimestampType(isAdjustedToUTC=utc, unit=unit)), None, None
    if upper == "INT":
        toks.expect("(")
        bits = int(toks.expect(kind="num"))
        if bits not in (8, 16, 32, 64):
            raise SchemaParseError(f"schema: INT bit width {bits} invalid at line {line}")
        toks.expect(",")
        signed_tok = toks.expect(kind="ident")
        if signed_tok not in ("true", "false"):
            raise SchemaParseError(f"schema: bad signed flag {signed_tok!r} at line {line}")
        signed = signed_tok == "true"
        toks.expect(")")
        toks.expect(")")
        conv = ConvertedType[f"{'INT' if signed else 'UINT'}_{bits}"]
        return conv, LogicalType(INTEGER=IntType(bitWidth=bits, isSigned=signed)), None, None
    raise SchemaParseError(f"schema: unknown annotation {v!r} at line {line}")


# -- printer -------------------------------------------------------------------

_TYPE_NAMES = {v: k for k, v in _PHYSICAL.items()}


def schema_to_string(schema: Schema) -> str:
    """Print a Schema as DSL text; parse(schema_to_string(s)) round-trips."""
    lines = [f"message {schema.root.name} {{"]
    for child in schema.root.children:
        _print_column(child, lines, 1)
    lines.append("}")
    return "\n".join(lines)


def _print_column(col: Column, lines: list[str], depth: int) -> None:
    ind = "  " * depth
    rep = col.repetition.name.lower()
    ann = _annotation_str(col)
    fid = f" = {col.element.field_id}" if col.element.field_id is not None else ""
    if col.is_leaf:
        t = _TYPE_NAMES[col.type]
        if col.type == Type.FIXED_LEN_BYTE_ARRAY:
            t = f"{t}({col.type_length})"
        lines.append(f"{ind}{rep} {t} {col.name}{ann}{fid};")
    else:
        lines.append(f"{ind}{rep} group {col.name}{ann}{fid} {{")
        for c in col.children:
            _print_column(c, lines, depth + 1)
        lines.append(f"{ind}}}")


def _annotation_str(col: Column) -> str:
    lt = col.logical_type
    if lt is not None:
        which = lt.which()
        if which == "STRING":
            return " (STRING)"
        if which == "ENUM":
            return " (ENUM)"
        if which == "JSON":
            return " (JSON)"
        if which == "BSON":
            return " (BSON)"
        if which == "DATE":
            return " (DATE)"
        if which == "UUID":
            return " (UUID)"
        if which == "MAP":
            return " (MAP)"
        if which == "LIST":
            return " (LIST)"
        if which == "DECIMAL":
            d = lt.DECIMAL
            return f" (DECIMAL({d.precision},{d.scale}))"
        if which == "TIME":
            t = lt.TIME
            return f" (TIME({t.unit.unit_name()},{'true' if t.isAdjustedToUTC else 'false'}))"
        if which == "TIMESTAMP":
            t = lt.TIMESTAMP
            return f" (TIMESTAMP({t.unit.unit_name()},{'true' if t.isAdjustedToUTC else 'false'}))"
        if which == "INTEGER":
            i = lt.INTEGER
            return f" (INT({i.bitWidth},{'true' if i.isSigned else 'false'}))"
    ct = col.converted_type
    if ct is not None:
        return f" ({ct.name})"
    return ""


# -- validation (reference: schema_parser.go:734-955) --------------------------


def validate(schema: Schema, strict: bool = False) -> None:
    for child in schema.root.children:
        _validate_column(child, strict)


def validate_strict(schema: Schema) -> None:
    validate(schema, strict=True)


def _validate_column(col: Column, strict: bool) -> None:
    ct = col.converted_type
    lt = col.logical_type
    is_list = ct == ConvertedType.LIST or (lt is not None and lt.LIST is not None)
    is_map = ct == ConvertedType.MAP or (lt is not None and lt.MAP is not None)
    if is_list:
        _validate_list(col, strict)
    elif is_map:
        _validate_map(col, strict)
    elif col.is_leaf:
        _validate_leaf(col)
    for c in col.children:
        _validate_column(c, strict)


def _validate_list(col: Column, strict: bool) -> None:
    if col.is_leaf:
        raise SchemaError(f"schema: LIST {col.path_str or col.name} must be a group")
    if col.repetition == FieldRepetitionType.REPEATED:
        raise SchemaError(f"schema: LIST {col.name} must not be repeated")
    if len(col.children) != 1:
        raise SchemaError(f"schema: LIST {col.name} must have one child")
    mid = col.children[0]
    if mid.repetition != FieldRepetitionType.REPEATED:
        raise SchemaError(f"schema: LIST {col.name} child must be repeated")
    if strict:
        if mid.name != "list" or (not mid.is_leaf and len(mid.children) == 1 and mid.children[0].name != "element"):
            # lenient mode accepts Athena's bag/array_element naming
            raise SchemaError(
                f"schema: LIST {col.name} child must be named 'list' with child 'element' (strict)"
            )


def _validate_map(col: Column, strict: bool) -> None:
    if col.is_leaf:
        raise SchemaError(f"schema: MAP {col.name} must be a group")
    if len(col.children) != 1:
        raise SchemaError(f"schema: MAP {col.name} must have one key_value child")
    kv = col.children[0]
    if kv.repetition != FieldRepetitionType.REPEATED or kv.is_leaf:
        raise SchemaError(f"schema: MAP {col.name} child must be a repeated group")
    if len(kv.children) != 2:
        raise SchemaError(f"schema: MAP {col.name} key_value must have key and value")
    if strict:
        if kv.name != "key_value":
            raise SchemaError(f"schema: MAP {col.name} child must be named key_value (strict)")
        if kv.children[0].name != "key" or kv.children[1].name != "value":
            raise SchemaError(f"schema: MAP {col.name} needs children key, value (strict)")
        if kv.children[0].repetition != FieldRepetitionType.REQUIRED:
            raise SchemaError(f"schema: MAP {col.name} key must be required (strict)")


def _validate_leaf(col: Column) -> None:
    ct = col.converted_type
    lt = col.logical_type
    t = col.type
    if ct == ConvertedType.UTF8 and t != Type.BYTE_ARRAY:
        raise SchemaError(f"schema: {col.name}: UTF8 requires binary")
    if lt is not None and lt.UUID is not None:
        if t != Type.FIXED_LEN_BYTE_ARRAY or col.type_length != 16:
            raise SchemaError(f"schema: {col.name}: UUID requires fixed_len_byte_array(16)")
    if lt is not None and lt.FLOAT16 is not None:
        if t != Type.FIXED_LEN_BYTE_ARRAY or col.type_length != 2:
            raise SchemaError(
                f"schema: {col.name}: FLOAT16 requires fixed_len_byte_array(2)"
            )
    if lt is not None and lt.INTEGER is not None:
        bits = lt.INTEGER.bitWidth or 0
        want = Type.INT64 if bits == 64 else Type.INT32
        if t != want:
            raise SchemaError(f"schema: {col.name}: INT({bits}) requires {want.name.lower()}")
    if ct == ConvertedType.DATE and t != Type.INT32:
        raise SchemaError(f"schema: {col.name}: DATE requires int32")
    if ct == ConvertedType.TIME_MILLIS and t != Type.INT32:
        raise SchemaError(f"schema: {col.name}: TIME_MILLIS requires int32")
    if ct in (ConvertedType.TIME_MICROS, ConvertedType.TIMESTAMP_MILLIS, ConvertedType.TIMESTAMP_MICROS) and t != Type.INT64:
        raise SchemaError(f"schema: {col.name}: {ct.name} requires int64")
    if ct == ConvertedType.DECIMAL:
        prec = col.element.precision or (lt.DECIMAL.precision if lt is not None and lt.DECIMAL else None)
        if prec is None or prec <= 0:
            raise SchemaError(f"schema: {col.name}: DECIMAL requires precision")
        if t == Type.INT32 and prec > 9:
            raise SchemaError(f"schema: {col.name}: DECIMAL({prec}) too wide for int32")
        if t == Type.INT64 and prec > 18:
            raise SchemaError(f"schema: {col.name}: DECIMAL({prec}) too wide for int64")
        if t == Type.FIXED_LEN_BYTE_ARRAY:
            n = col.type_length or 0
            import math

            max_digits = math.floor(math.log10(2) * (8 * n - 1))
            if prec > max_digits:
                raise SchemaError(
                    f"schema: {col.name}: DECIMAL({prec}) exceeds fixed({n}) capacity"
                )
    if lt is not None and lt.TIME is not None:
        unit = lt.TIME.unit
        if unit is not None and unit.MILLIS is not None and t != Type.INT32:
            raise SchemaError(f"schema: {col.name}: TIME(MILLIS) requires int32")
        if unit is not None and (unit.MICROS is not None or unit.NANOS is not None) and t != Type.INT64:
            raise SchemaError(f"schema: {col.name}: TIME(MICROS/NANOS) requires int64")
