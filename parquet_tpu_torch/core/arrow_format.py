"""Arrow arrays, tables and types without pyarrow.

The port's stand-in for the pyarrow objects the reference's Arrow surface
touches (FileReader.to_arrow, core/arrow_nested.py, the writer's Arrow
ingest, the daemon's arrow-ipc streams): the Arrow columnar layout itself,
held in NumPy buffers. The factory names are pyarrow's (`int64()`,
`large_list(t)`, `field(...)`, `schema(...)`, `array(...)`,
`Array.from_buffers(...)`, `chunked_array(...)`, `table(...)`), so the
copies of the reference's code read nearly line for line with `pa` bound to
this module.

Layout (the Arrow columnar format's): an Array is a type, a length, an
offset into its buffers, a null count and its buffers (validity first, an
LSB-first bitmap, or None), plus child arrays for nested types and the
dictionary for a dictionary type. Buffers are uint8 NumPy arrays, sized
exactly as they were given (the IPC writer, core/arrow_ipc.py, writes what
pyarrow writes for the same buffers):

  null                        [None]
  bool                        [validity, bits]
  ints, floats, temporal,
  decimal128, binary(n)       [validity, values]
  string / binary             [validity, int32 offsets, data]
  large_string / large_binary [validity, int64 offsets, data]
  list / large_list / map     [validity, offsets]   + the values child
  struct                      [validity]            + one child a field
  dictionary                  [validity, indices]   + the dictionary

to_pylist() gives what pyarrow's gives: datetime / date / time for the
temporal types (tz-aware where a tz is set), Decimal for decimal128, a list
of (key, value) tuples for a map, and NanoTimestamp for timestamp[ns] (the
rendering the reference's values take with pandas installed).
"""

from __future__ import annotations

import datetime
import decimal

import numpy as np

__all__ = [
    "ArrowInvalid",
    "ArrowTypeError",
    "DataType",
    "Field",
    "Schema",
    "Array",
    "ChunkedArray",
    "RecordBatch",
    "Table",
    "LargeListArray",
    "MapArray",
    "StructArray",
    "DictionaryArray",
    "NanoTimestamp",
    "types",
    "null",
    "bool_",
    "int8",
    "int16",
    "int32",
    "int64",
    "uint8",
    "uint16",
    "uint32",
    "uint64",
    "float16",
    "float32",
    "float64",
    "string",
    "large_string",
    "binary",
    "large_binary",
    "decimal128",
    "date32",
    "time32",
    "time64",
    "timestamp",
    "list_",
    "large_list",
    "struct",
    "map_",
    "dictionary",
    "field",
    "schema",
    "py_buffer",
    "array",
    "concat_arrays",
    "chunked_array",
    "table",
]


class ArrowInvalid(ValueError):
    """An invalid value, layout or stream (pyarrow's ArrowInvalid)."""


class ArrowTypeError(TypeError):
    """A type the operation does not take (pyarrow's ArrowTypeError)."""


# -- types ------------------------------------------------------------------------


class DataType:
    """An Arrow type: `kind` names the layout family, the keyword
    parameters the rest (bit_width / signed, unit / tz, precision / scale,
    byte_width, value_field, fields, index_type / value_type)."""

    __slots__ = ("kind", "_params", "__dict__")

    def __init__(self, kind: str, **params):
        self.kind = kind
        self._params = tuple(sorted(params.items()))
        self.__dict__.update(params)

    def __eq__(self, other):
        return (
            isinstance(other, DataType)
            and self.kind == other.kind
            and self._params == other._params
        )

    def __hash__(self):
        return hash((self.kind, self._params))

    def equals(self, other) -> bool:
        return self == other

    @property
    def id(self) -> str:
        return self.kind

    @property
    def value_type(self):
        if self.kind == "dictionary":
            return self.__dict__["value_type"]
        if self.kind in ("list", "large_list"):
            return self.value_field.type
        raise AttributeError("value_type")

    def __str__(self) -> str:
        k = self.kind
        if k == "int":
            return f"{'' if self.signed else 'u'}int{self.bit_width}"
        if k == "float":
            return {16: "halffloat", 32: "float", 64: "double"}[self.bit_width]
        if k == "fixed_size_binary":
            return f"fixed_size_binary[{self.byte_width}]"
        if k == "decimal128":
            return f"decimal128({self.precision}, {self.scale})"
        if k == "date32":
            return "date32[day]"
        if k in ("time32", "time64"):
            return f"{k}[{self.unit}]"
        if k == "timestamp":
            return f"timestamp[{self.unit}" + (f", tz={self.tz}]" if self.tz else "]")
        if k in ("list", "large_list"):
            vf = self.value_field
            inner = f"{vf.name}: {vf.type}" + ("" if vf.nullable else " not null")
            return f"{k}<{inner}>"
        if k == "map":
            key, item = self.value_field.type.fields
            return f"map<{key.type}, {item.type}>"
        if k == "struct":
            return "struct<" + ", ".join(
                f"{f.name}: {f.type}" + ("" if f.nullable else " not null")
                for f in self.fields
            ) + ">"
        if k == "dictionary":
            return (
                f"dictionary<values={self.value_type}, indices={self.index_type}, "
                f"ordered={int(self.ordered)}>"
            )
        return k

    __repr__ = __str__


class Field:
    """A named, typed, nullable slot of a schema or a nested type."""

    __slots__ = ("name", "type", "nullable")

    def __init__(self, name: str, type: DataType, nullable: bool = True):
        self.name = name
        self.type = type
        self.nullable = bool(nullable)

    def __eq__(self, other):
        return (
            isinstance(other, Field)
            and (self.name, self.type, self.nullable)
            == (other.name, other.type, other.nullable)
        )

    def __hash__(self):
        return hash((self.name, self.type, self.nullable))

    def equals(self, other) -> bool:
        return self == other

    def __repr__(self):
        return f"Field<{self.name}: {self.type}{'' if self.nullable else ' not null'}>"


def _int(bits, signed):
    return DataType("int", bit_width=bits, signed=signed)


def null():
    return DataType("null")


def bool_():
    return DataType("bool")


def int8():
    return _int(8, True)


def int16():
    return _int(16, True)


def int32():
    return _int(32, True)


def int64():
    return _int(64, True)


def uint8():
    return _int(8, False)


def uint16():
    return _int(16, False)


def uint32():
    return _int(32, False)


def uint64():
    return _int(64, False)


def float16():
    return DataType("float", bit_width=16)


def float32():
    return DataType("float", bit_width=32)


def float64():
    return DataType("float", bit_width=64)


def string():
    return DataType("string")



def large_string():
    return DataType("large_string")



def binary(length: int = -1):
    """binary() is variable-width; binary(n) is fixed_size_binary[n]."""
    if length == -1:
        return DataType("binary")
    return DataType("fixed_size_binary", byte_width=int(length))


def large_binary():
    return DataType("large_binary")


def decimal128(precision: int, scale: int = 0):
    if not 1 <= precision <= 38:
        raise ArrowInvalid(f"Decimal precision out of range [1, 38]: {precision}")
    return DataType("decimal128", precision=int(precision), scale=int(scale))


def date32():
    return DataType("date32")


def time32(unit: str):
    if unit not in ("s", "ms"):
        raise ValueError(f"Invalid time unit for time32: {unit!r}")
    return DataType("time32", unit=unit)


def time64(unit: str):
    if unit not in ("us", "ns"):
        raise ValueError(f"Invalid time unit for time64: {unit!r}")
    return DataType("time64", unit=unit)


def timestamp(unit: str, tz=None):
    if unit not in ("s", "ms", "us", "ns"):
        raise ValueError(f"Invalid time unit: {unit!r}")
    return DataType("timestamp", unit=unit, tz=tz)


def _as_field(value_type, name="item"):
    return value_type if isinstance(value_type, Field) else Field(name, value_type)


def list_(value_type):
    return DataType("list", value_field=_as_field(value_type))


def large_list(value_type):
    return DataType("large_list", value_field=_as_field(value_type))


def struct(fields):
    out = []
    for f in fields:
        if isinstance(f, Field):
            out.append(f)
        else:
            name, t = f
            out.append(Field(name, t))
    return DataType("struct", fields=tuple(out))


def map_(key_type, item_type, keys_sorted: bool = False):
    entries = struct(
        [Field("key", key_type, nullable=False), _as_field(item_type, "value")]
    )
    return DataType(
        "map", value_field=Field("entries", entries, nullable=False),
        keys_sorted=bool(keys_sorted),
    )


def dictionary(index_type, value_type, ordered: bool = False):
    if index_type.kind != "int":
        raise ArrowTypeError(f"dictionary index type must be an integer: {index_type}")
    return DataType(
        "dictionary", index_type=index_type, value_type=value_type,
        ordered=bool(ordered),
    )


def field(name, type, nullable: bool = True):
    return Field(name, type, nullable)


class Schema:
    """An ordered list of fields."""

    __slots__ = ("fields",)

    def __init__(self, fields):
        self.fields = [
            f if isinstance(f, Field) else Field(f[0], f[1]) for f in fields
        ]

    @property
    def names(self) -> list:
        return [f.name for f in self.fields]

    def field(self, i):
        if isinstance(i, str):
            for f in self.fields:
                if f.name == i:
                    return f
            raise KeyError(i)
        return self.fields[i]

    def get_field_index(self, name: str) -> int:
        names = self.names
        return names.index(name) if names.count(name) == 1 else -1

    def __len__(self):
        return len(self.fields)

    def __iter__(self):
        return iter(self.fields)

    def __eq__(self, other):
        return isinstance(other, Schema) and self.fields == other.fields

    def equals(self, other) -> bool:
        return self == other

    def __repr__(self):
        return "\n".join(
            f"{f.name}: {f.type}" + ("" if f.nullable else " not null")
            for f in self.fields
        )


def schema(fields):
    return Schema(fields)


class _Types:
    """pyarrow.types' predicates over the port's DataType (those the
    copies of the reference's code call)."""

    @staticmethod
    def is_dictionary(t):
        return t.kind == "dictionary"

    @staticmethod
    def is_decimal(t):
        return t.kind == "decimal128"

    @staticmethod
    def is_temporal(t):
        return t.kind in ("date32", "time32", "time64", "timestamp")


types = _Types()

# the fixed-width kinds: NumPy storage dtype of one value (decimal128 and
# fixed_size_binary are byte rows)
_VAR = {"string": np.int32, "binary": np.int32,
        "large_string": np.int64, "large_binary": np.int64}
_LIST_OFFSETS = {"list": np.int32, "map": np.int32, "large_list": np.int64}
_TEMPORAL = {"date32": np.int32, "time32": np.int32, "time64": np.int64,
             "timestamp": np.int64}


def _np_dtype(t: DataType):
    """NumPy dtype of a fixed-width type's values, or None for byte rows."""
    k = t.kind
    if k == "int":
        return np.dtype(f"{'i' if t.signed else 'u'}{t.bit_width // 8}")
    if k == "float":
        return np.dtype(f"f{t.bit_width // 8}")
    if k in _TEMPORAL:
        return np.dtype(_TEMPORAL[k])
    if k == "dictionary":
        return _np_dtype(t.index_type)
    return None


def byte_width(t: DataType) -> int:
    """Bytes a value of a fixed-width type takes (0 for other layouts)."""
    dt = _np_dtype(t)
    if dt is not None:
        return dt.itemsize
    if t.kind == "decimal128":
        return 16
    if t.kind == "fixed_size_binary":
        return t.byte_width
    return 0


def _from_np_dtype(dt) -> DataType:
    dt = np.dtype(dt)
    if dt.kind == "b":
        return bool_()
    if dt.kind in "iu":
        return _int(dt.itemsize * 8, dt.kind == "i")
    if dt.kind == "f":
        return DataType("float", bit_width=dt.itemsize * 8)
    raise ArrowTypeError(f"no Arrow type for NumPy dtype {dt}")


def py_buffer(obj):
    """A buffer as the uint8 NumPy array the arrays hold (zero-copy where
    the object's memory is contiguous)."""
    if obj is None:
        return None
    if isinstance(obj, np.ndarray):
        a = obj if obj.flags.c_contiguous else np.ascontiguousarray(obj)
        return a.reshape(-1).view(np.uint8)
    return np.frombuffer(obj, dtype=np.uint8)


def _bits(buf, offset: int, length: int) -> np.ndarray:
    """bool[length] of an LSB-first bitmap from bit `offset`."""
    if length == 0:
        return np.zeros(0, dtype=bool)
    lo = offset >> 3
    hi = (offset + length + 7) >> 3
    bits = np.unpackbits(buf[lo:hi], bitorder="little")
    start = offset & 7
    return bits[start : start + length].astype(bool)


def _pack(bools) -> np.ndarray:
    return np.packbits(np.asarray(bools, dtype=bool), bitorder="little")


# -- values ------------------------------------------------------------------------

_EPOCH = datetime.datetime(1970, 1, 1)
_EPOCH_UTC = datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)
_EPOCH_DATE = datetime.date(1970, 1, 1)
_TS_US = {"s": 1_000_000, "ms": 1000, "us": 1}


class NanoTimestamp:
    """A timestamp[ns] value as the reference's as_py() gives it with
    pandas installed (pandas.Timestamp): equal, hashed and ordered by its
    nanoseconds, and str() as pandas renders it (nine fractional digits
    where the nanoseconds are not whole microseconds). Without pandas the
    reference raises on such a value (ROADMAP section 3)."""

    __slots__ = ("value", "utc")

    def __init__(self, value: int, utc: bool):
        self.value = value
        self.utc = utc

    def __str__(self) -> str:
        us, ns = divmod(self.value, 1000)
        dt = (_EPOCH_UTC if self.utc else _EPOCH) + datetime.timedelta(microseconds=us)
        s = dt.strftime("%Y-%m-%d %H:%M:%S")
        if ns:
            s += f".{dt.microsecond:06d}{ns:03d}"
        elif dt.microsecond:
            s += f".{dt.microsecond:06d}"
        return s + ("+00:00" if self.utc else "")

    def __repr__(self) -> str:
        return f"NanoTimestamp({self})"

    def __eq__(self, other):
        return isinstance(other, NanoTimestamp) and self.value == other.value

    def __hash__(self):
        return hash(self.value)

    def __lt__(self, other):
        return self.value < other.value

    def __gt__(self, other):
        return self.value > other.value


def _tzinfo(tz):
    if tz is None:
        return None
    if tz in ("UTC", "utc", "+00:00", "Z"):
        return datetime.timezone.utc
    import zoneinfo

    try:
        return zoneinfo.ZoneInfo(tz)
    except Exception as e:  # noqa: BLE001 - an unknown zone name is the stream's fault
        raise ArrowInvalid(f"unknown time zone {tz!r}") from e


def _decimal_py(raw: bytes, scale: int):
    u = int.from_bytes(raw, "little", signed=True)
    digits = tuple(int(c) for c in str(abs(u)))
    return decimal.Decimal((1 if u < 0 else 0, digits, -scale))


def _scalar_list(t: DataType, vals: list) -> list:
    """Physical values (ints, floats) as pyarrow's to_pylist gives them."""
    k = t.kind
    if k == "date32":
        return [_EPOCH_DATE + datetime.timedelta(days=v) for v in vals]
    if k in ("time32", "time64"):
        div = {"s": None, "ms": None, "us": 1, "ns": 1000}[t.unit]
        mul = {"s": 1_000_000, "ms": 1000}.get(t.unit, 1)
        return [
            (_EPOCH + datetime.timedelta(
                microseconds=(v * mul if div is None else v // div)
            )).time()
            for v in vals
        ]
    if k == "timestamp":
        if t.unit == "ns":
            return [NanoTimestamp(v, t.tz is not None) for v in vals]
        tzi = _tzinfo(t.tz)
        per = _TS_US[t.unit]
        if tzi is None:
            return [_EPOCH + datetime.timedelta(microseconds=v * per) for v in vals]
        return [
            (_EPOCH_UTC + datetime.timedelta(microseconds=v * per)).astimezone(tzi)
            for v in vals
        ]
    return vals


# -- arrays ------------------------------------------------------------------------


class Array:
    """One Arrow array (see the module docstring for its buffers)."""

    __slots__ = ("type", "length", "offset", "_null_count", "_buffers",
                 "children", "dictionary")

    def __init__(self, type, length, buffers, null_count=-1, offset=0,
                 children=(), dictionary=None):
        self.type = type
        self.length = int(length)
        self.offset = int(offset)
        self._buffers = [py_buffer(b) for b in buffers]
        self.children = list(children)
        self.dictionary = dictionary
        if self._buffers and self._buffers[0] is None and type.kind != "null":
            null_count = 0
        if type.kind == "null":
            null_count = self.length
        self._null_count = -1 if null_count is None else int(null_count)

    # -- construction -----------------------------------------------------------

    @classmethod
    def from_buffers(cls, type, length, buffers, null_count=-1, offset=0,
                     children=None):
        """pyarrow's Array.from_buffers: this type's own buffers (validity
        first), and the child arrays of a nested type."""
        buffers = list(buffers)
        k = type.kind
        if k == "dictionary":
            raise ArrowTypeError("use DictionaryArray.from_arrays")
        want = _n_buffers(type)
        if len(buffers) != want:
            raise ArrowInvalid(
                f"Type {type} expected {want} buffers, got {len(buffers)}"
            )
        return cls(type, length, buffers, null_count, offset, children or ())

    # -- pyarrow's accessors ----------------------------------------------------

    def __len__(self):
        return self.length

    @property
    def null_count(self) -> int:
        if self._null_count < 0:
            v = self._buffers[0]
            self._null_count = (
                0 if v is None
                else self.length - int(_bits(v, self.offset, self.length).sum())
            )
        return self._null_count

    @property
    def nbytes(self) -> int:
        """Bytes of the buffers (and the dictionary) the array holds."""
        n = sum(len(b) for b in self.buffers() if b is not None)
        return n + (self.dictionary.nbytes if self.dictionary is not None else 0)

    def buffers(self) -> list:
        """This array's buffers, then its children's, depth first (the
        dictionary's are not listed, as in pyarrow)."""
        out = list(self._buffers)
        for c in self.children:
            out.extend(c.buffers())
        return out

    def is_valid_np(self):
        """bool[len] validity, or None where every slot is valid."""
        if self.type.kind == "null":
            return np.zeros(self.length, dtype=bool)
        if self._buffers[0] is None or self.null_count == 0:
            return None
        return _bits(self._buffers[0], self.offset, self.length)

    def values_np(self):
        """A fixed-width array's values over its window: a typed view, or
        (len, width) uint8 rows for decimal128 / binary(n); bool unpacked."""
        t = self.type
        if t.kind == "bool":
            return _bits(self._buffers[1], self.offset, self.length)
        dt = _np_dtype(t)
        w = byte_width(t)
        if not w:
            raise ArrowTypeError(f"{t} has no fixed-width values")
        data = self._buffers[1]
        raw = data[self.offset * w : (self.offset + self.length) * w]
        if len(raw) != self.length * w:
            raise ArrowInvalid(f"{t} buffer holds fewer than {self.length} values")
        if dt is None:
            return raw.reshape(self.length, w)
        return raw.view(dt)

    def offsets_np(self):
        """The length + 1 offsets of a variable-width or list array's
        window, as int64 (absolute into its data or child)."""
        dt = _VAR.get(self.type.kind) or _LIST_OFFSETS.get(self.type.kind)
        if dt is None:
            raise ArrowTypeError(f"{self.type} has no offsets")
        w = np.dtype(dt).itemsize
        raw = self._buffers[1][self.offset * w : (self.offset + self.length + 1) * w]
        if len(raw) != (self.length + 1) * w:
            raise ArrowInvalid(f"{self.type} offsets shorter than its length")
        return raw.view(dt).astype(np.int64)

    def data_np(self):
        """A variable-width array's data buffer (whole)."""
        d = self._buffers[2]
        return np.zeros(0, dtype=np.uint8) if d is None else d

    @property
    def values(self):
        """A list array's child (whole, as pyarrow's .values)."""
        return self.children[0]

    def field(self, i):
        """A struct's child i, windowed to this array."""
        if isinstance(i, str):
            i = [f.name for f in self.type.fields].index(i)
        c = self.children[i]
        if self.offset or len(c) != self.length:
            return c.slice(self.offset, self.length)
        return c

    def slice(self, offset: int = 0, length=None):
        offset = max(0, min(int(offset), self.length))
        rest = self.length - offset
        length = rest if length is None else max(0, min(int(length), rest))
        if offset == 0 and length == self.length:
            return self
        return Array(self.type, length, self._buffers, -1, self.offset + offset,
                     self.children, self.dictionary)

    # -- conversions ------------------------------------------------------------

    def to_pylist(self) -> list:
        t = self.type
        k = t.kind
        n = self.length
        if k == "null":
            return [None] * n
        valid = self.is_valid_np()
        if k == "dictionary":
            idx = self.values_np().tolist()
            d = self.dictionary.to_pylist()
            try:
                out = [d[i] for i in idx] if valid is None else [
                    d[i] if ok else None for i, ok in zip(idx, valid.tolist())
                ]
            except IndexError as e:
                raise ArrowInvalid(f"dictionary index out of range: {e}") from e
            return out
        if k in _VAR:
            off = self.offsets_np().tolist()
            data = self.data_np().tobytes()
            if k in ("string", "large_string"):
                try:
                    vals = [data[a:b].decode("utf-8") for a, b in zip(off[:-1], off[1:])]
                except UnicodeDecodeError as e:
                    raise ArrowInvalid(f"invalid UTF-8 in a string array: {e}") from e
            else:
                vals = [data[a:b] for a, b in zip(off[:-1], off[1:])]
        elif k in _LIST_OFFSETS:
            off = self.offsets_np()
            base = int(off[0]) if n else 0
            end = int(off[-1]) if n else 0
            child = self.children[0].slice(base, end - base).to_pylist()
            o = (off - base).tolist()
            if k == "map":
                child = [(e["key"], e["value"]) for e in child]
            vals = [child[a:b] for a, b in zip(o[:-1], o[1:])]
        elif k == "struct":
            names = [f.name for f in t.fields]
            cols = [self.field(i).to_pylist() for i in range(len(names))]
            vals = [dict(zip(names, row)) for row in zip(*cols)] if cols else [
                {} for _ in range(n)
            ]
        elif k == "decimal128":
            rows = self.values_np()
            vals = [_decimal_py(r.tobytes(), t.scale) for r in rows]
        elif k == "fixed_size_binary":
            rows = self.values_np()
            vals = [r.tobytes() for r in rows]
        elif k == "float" and t.bit_width == 16:
            vals = self.values_np().astype(np.float64).tolist()
        else:
            vals = self.values_np().tolist()
            if valid is not None:
                vals = [v if ok else None for v, ok in zip(vals, valid.tolist())]
                keep = [v for v in vals if v is not None]
                conv = iter(_scalar_list(t, keep))
                return [None if v is None else next(conv) for v in vals]
            return _scalar_list(t, vals)
        if valid is not None:
            return [v if ok else None for v, ok in zip(vals, valid.tolist())]
        return vals

    def to_numpy(self, zero_copy_only: bool = True):
        if self.null_count:
            raise ArrowInvalid("to_numpy of an array with nulls")
        if self.type.kind == "bool":
            if zero_copy_only:
                raise ArrowInvalid("bool arrays are bit-packed: no zero-copy view")
            return self.values_np()
        dt = _np_dtype(self.type)
        if dt is None or self.type.kind == "dictionary":
            raise ArrowInvalid(f"no NumPy view of {self.type}")
        return self.values_np()

    def dictionary_decode(self):
        if self.type.kind != "dictionary":
            return self
        idx = self.values_np().astype(np.int64)
        valid = self.is_valid_np()
        live = idx if valid is None else idx[valid]
        if len(live) and (live.min() < 0 or live.max() >= len(self.dictionary)):
            raise ArrowInvalid("dictionary index out of range")
        if not len(live):
            return _nulls(self.type.value_type, self.length)
        if valid is not None:
            idx = np.where(valid, idx, int(live[0]))
        out = _take(self.dictionary, idx)
        if valid is None:
            return out
        dv = out.is_valid_np()
        return _with_validity(out, valid if dv is None else (valid & dv))

    def cast(self, target: DataType, safe: bool = True):
        """Dictionary -> its value type, and integer casts that keep every
        value (a value out of the target's range is ArrowInvalid)."""
        t = self.type
        if t == target:
            return self
        if t.kind == "dictionary" and target == t.value_type:
            return self.dictionary_decode()
        if t.kind == "int" and target.kind == "int":
            v = self.values_np()
            valid = self.is_valid_np()
            dt = _np_dtype(target)
            info = np.iinfo(dt)
            chk = v if valid is None else v[valid]
            if safe and len(chk) and (
                int(chk.min()) < info.min or int(chk.max()) > info.max
            ):
                raise ArrowInvalid(
                    f"Integer value {int(chk.max()) if int(chk.max()) > info.max else int(chk.min())} "
                    f"not in range: {info.min} to {info.max}"
                )
            return Array(target, self.length,
                         [_validity_buffer(valid), v.astype(dt)],
                         self.null_count if valid is not None else 0)
        raise ArrowTypeError(f"Unsupported cast from {t} to {target}")

    def view(self, target: DataType):
        """Reinterpret a fixed-width array as a type of the same width."""
        if byte_width(target) != byte_width(self.type) or not byte_width(target):
            raise ArrowInvalid(f"cannot view {self.type} as {target}")
        return Array(target, self.length, self._buffers, self._null_count,
                     self.offset)

    def take(self, indices):
        idx = np.asarray(
            indices.to_pylist() if isinstance(indices, Array) else indices,
            dtype=np.int64,
        )
        if len(idx) and (idx.min() < 0 or idx.max() >= self.length):
            raise IndexError("take: index out of bounds")
        return _take(self, idx)

    def filter(self, mask):
        m = mask.to_pylist() if isinstance(mask, Array) else mask
        m = np.asarray([bool(x) for x in m] if isinstance(m, list) else m, dtype=bool)
        if len(m) != self.length:
            raise ArrowInvalid("filter mask length differs from the array's")
        return _take(self, np.flatnonzero(m))

    def equals(self, other) -> bool:
        return (
            isinstance(other, Array)
            and self.type == other.type
            and self.to_pylist() == other.to_pylist()
        )

    def __eq__(self, other):
        return self.equals(other)

    __hash__ = None

    def __repr__(self):
        return f"<{self.type} array of {self.length}>"


def _nulls(t: DataType, n: int) -> Array:
    """An array of n nulls of type t."""
    k = t.kind
    if k == "null":
        return Array(t, n, [None])
    vb = np.zeros((n + 7) // 8, dtype=np.uint8) if n else None
    if k == "bool":
        return Array(t, n, [vb, np.zeros((n + 7) // 8, np.uint8)], n)
    if k == "dictionary":
        return Array(t, n, [vb, np.zeros(n, _np_dtype(t.index_type))], n, 0, (),
                     _empty(t.value_type))
    if byte_width(t):
        return Array(t, n, [vb, np.zeros(n * byte_width(t), np.uint8)], n)
    if k in _VAR:
        return Array(t, n, [vb, np.zeros(n + 1, _VAR[k]), np.zeros(0, np.uint8)], n)
    if k in _LIST_OFFSETS:
        return Array(t, n, [vb, np.zeros(n + 1, _LIST_OFFSETS[k])], n, 0,
                     [_empty(t.value_field.type)])
    if k == "struct":
        return Array(t, n, [vb], n, 0, [_nulls(f.type, n) for f in t.fields])
    raise ArrowTypeError(f"nulls of {t}")


def _n_buffers(t: DataType) -> int:
    k = t.kind
    if k == "null":
        return 1
    if k in _VAR:
        return 3
    if k == "struct":
        return 1
    return 2


def _validity_buffer(valid):
    return None if valid is None or valid.all() else _pack(valid)


def _with_validity(arr: Array, valid) -> Array:
    """`arr` (offset 0) with its validity replaced by `valid`."""
    bufs = list(arr._buffers)
    bufs[0] = _validity_buffer(valid)
    nc = 0 if bufs[0] is None else int((~valid).sum())
    return Array(arr.type, arr.length, bufs, nc, 0, arr.children, arr.dictionary)


def _gather_spans(starts, lens):
    """Positions of the concatenated spans [starts[i], starts[i] + lens[i])."""
    total = int(lens.sum()) if len(lens) else 0
    if not total:
        return np.zeros(0, dtype=np.int64), np.zeros(len(lens) + 1, dtype=np.int64)
    out_off = np.zeros(len(lens) + 1, dtype=np.int64)
    np.cumsum(lens, out=out_off[1:])
    pos = np.repeat(starts - out_off[:-1], lens) + np.arange(total, dtype=np.int64)
    return pos, out_off


def _take(a: Array, idx) -> Array:
    """The rows `idx` (logical, in range) of `a`, as an offset-0 array."""
    t = a.type
    k = t.kind
    n = len(idx)
    if k == "null":
        return Array(t, n, [None])
    valid = a.is_valid_np()
    v = None if valid is None else valid[idx]
    vb = _validity_buffer(v)
    nc = 0 if vb is None else int((~v).sum())
    if k == "bool":
        return Array(t, n, [vb, _pack(a.values_np()[idx])], nc)
    if k == "dictionary":
        return Array(t, n, [vb, a.values_np()[idx]], nc, 0, (), a.dictionary)
    if byte_width(t):
        return Array(t, n, [vb, np.ascontiguousarray(a.values_np()[idx])], nc)
    if k in _VAR or k in _LIST_OFFSETS:
        off = a.offsets_np()
        starts = off[:-1][idx]
        lens = off[1:][idx] - starts
        pos, out_off = _gather_spans(starts, lens)
        if k in _VAR:
            data = a.data_np()[pos]
            return Array(t, n, [vb, out_off.astype(_VAR[k]), data], nc)
        child = _take(a.children[0], pos)
        return Array(t, n, [vb, out_off.astype(_LIST_OFFSETS[k])], nc, 0, [child])
    if k == "struct":
        return Array(t, n, [vb], nc, 0,
                     [_take(a.field(i), idx) for i in range(len(a.children))])
    raise ArrowTypeError(f"take of {t}")


def _rebased(a: Array) -> Array:
    return _take(a, np.arange(a.length, dtype=np.int64)) if a.offset else a


def concat_arrays(arrays) -> Array:
    """One array of the arrays' values, in order (they share a type;
    dictionary arrays with different dictionaries concatenate theirs)."""
    arrays = list(arrays)
    if not arrays:
        raise ArrowInvalid("concat_arrays needs at least one array")
    t = arrays[0].type
    for a in arrays[1:]:
        if a.type != t:
            raise ArrowInvalid(f"arrays to be concatenated must be identically typed, "
                               f"but {t} and {a.type} were encountered.")
    if len(arrays) == 1:
        return _rebased(arrays[0])
    k = t.kind
    n = sum(len(a) for a in arrays)
    if k == "null":
        return Array(t, n, [None])
    vals = [a.is_valid_np() for a in arrays]
    if all(v is None for v in vals):
        vb, nc = None, 0
    else:
        v = np.concatenate([np.ones(len(a), bool) if x is None else x
                            for a, x in zip(arrays, vals)])
        vb, nc = _validity_buffer(v), int((~v).sum())
    if k == "bool":
        return Array(t, n, [vb, _pack(np.concatenate([a.values_np() for a in arrays]))], nc)
    if k == "dictionary":
        d0 = arrays[0].dictionary
        if all(a.dictionary is d0 or a.dictionary.equals(d0) for a in arrays):
            return Array(t, n, [vb, np.concatenate([a.values_np() for a in arrays])],
                         nc, 0, (), d0)
        shift, idx = 0, []
        for a in arrays:
            idx.append(a.values_np().astype(np.int64) + shift)
            shift += len(a.dictionary)
        dt = _np_dtype(t.index_type)
        return Array(t, n, [vb, np.concatenate(idx).astype(dt)], nc, 0, (),
                     concat_arrays([a.dictionary for a in arrays]))
    if byte_width(t):
        return Array(t, n, [vb, np.concatenate(
            [np.ascontiguousarray(a.values_np()).reshape(-1).view(np.uint8)
             for a in arrays])], nc)
    if k in _VAR or k in _LIST_OFFSETS:
        offs, parts, base = [np.zeros(1, dtype=np.int64)], [], 0
        for a in arrays:
            off = a.offsets_np()
            lo, hi = (int(off[0]), int(off[-1])) if len(a) else (0, 0)
            offs.append(off[1:] - lo + base)
            base += hi - lo
            parts.append(a.data_np()[lo:hi] if k in _VAR
                         else a.children[0].slice(lo, hi - lo))
        odt = _VAR.get(k) or _LIST_OFFSETS[k]
        out_off = np.concatenate(offs).astype(odt)
        if k in _VAR:
            return Array(t, n, [vb, out_off, np.concatenate(parts)], nc)
        return Array(t, n, [vb, out_off], nc, 0, [concat_arrays(parts)])
    if k == "struct":
        return Array(t, n, [vb], nc, 0, [
            concat_arrays([a.field(i) for a in arrays]) for i in range(len(t.fields))
        ])
    raise ArrowTypeError(f"concat of {t}")


class LargeListArray:
    @staticmethod
    def from_arrays(offsets, values):
        return _list_from_arrays(large_list(values.type), offsets, values)


class MapArray:
    @staticmethod
    def from_arrays(offsets, keys, items):
        entries = StructArray.from_arrays(
            [keys, items],
            fields=[Field("key", keys.type, False), Field("value", items.type)],
        )
        return _list_from_arrays(map_(keys.type, items.type), offsets, entries)


def _list_from_arrays(t: DataType, offsets, values):
    """pyarrow's ListArray.from_arrays: a null offset at i makes list i
    null (the offsets' own validity, less its last entry)."""
    if isinstance(offsets, Array):
        valid = offsets.is_valid_np()
        off = offsets.values_np().astype(np.int64)
    else:
        valid = None
        off = np.asarray(offsets, dtype=np.int64)
    n = len(off) - 1
    vb = None
    nc = 0
    if valid is not None and not valid[:-1].all():
        vb = _pack(valid[:-1])
        nc = int((~valid[:-1]).sum())
    dt = _LIST_OFFSETS[t.kind]
    return Array(t, n, [vb, off.astype(dt)], nc, 0, [values])


class StructArray:
    @staticmethod
    def from_arrays(arrays, names=None, fields=None, mask=None):
        if fields is None:
            fields = [Field(nm, a.type) for nm, a in zip(names, arrays)]
        n = len(arrays[0]) if arrays else (0 if mask is None else len(mask))
        vb, nc = None, 0
        if mask is not None:
            m = mask.values_np() if isinstance(mask, Array) else np.asarray(mask, bool)
            if m.any():
                vb, nc = _pack(~m), int(m.sum())
        return Array(struct(fields), n, [vb], nc, 0, list(arrays))


class DictionaryArray:
    @staticmethod
    def from_arrays(indices, dictionary, ordered: bool = False):
        if not isinstance(indices, Array):
            indices = array(np.asarray(indices))
        t = DataType("dictionary", index_type=indices.type,
                     value_type=dictionary.type, ordered=bool(ordered))
        return Array(t, len(indices), indices._buffers, indices._null_count,
                     indices.offset, (), dictionary)


def _empty(t: DataType) -> Array:
    k = t.kind
    if k == "null":
        return Array(t, 0, [None])
    if k in _VAR:
        return Array(t, 0, [None, np.zeros(1, dtype=_VAR[k]), np.zeros(0, np.uint8)])
    if k in _LIST_OFFSETS:
        return Array(t, 0, [None, np.zeros(1, dtype=_LIST_OFFSETS[k])], 0, 0,
                     [_empty(t.value_field.type)])
    if k == "struct":
        return Array(t, 0, [None], 0, 0, [_empty(f.type) for f in t.fields])
    if k == "dictionary":
        return Array(t, 0, [None, np.zeros(0, _np_dtype(t.index_type))], 0, 0, (),
                     _empty(t.value_type))
    return Array(t, 0, [None, np.zeros(0, np.uint8)])


def array(obj, type=None, mask=None):
    """An array from a NumPy array (its dtype gives the type unless `type`
    does; `mask` True marks nulls), a list of bytes / None for binary(n),
    or an empty list of any type."""
    if isinstance(obj, Array):
        return obj if type is None or obj.type == type else obj.cast(type)
    if isinstance(obj, (list, tuple)) and len(obj) == 0:
        if type is None:
            return _empty(null())
        return _empty(type)
    if isinstance(obj, (list, tuple)):
        if type is not None and type.kind == "fixed_size_binary":
            w = type.byte_width
            valid = np.array([x is not None for x in obj], dtype=bool)
            rows = np.zeros((len(obj), w), dtype=np.uint8)
            for i, x in enumerate(obj):
                if x is not None:
                    if len(x) != w:
                        raise ArrowInvalid(f"expected {w}-byte values, got {len(x)}")
                    rows[i] = np.frombuffer(x, dtype=np.uint8)
            return Array(type, len(obj), [_validity_buffer(valid), rows])
        if type is not None and type.kind == "null":
            return Array(type, len(obj), [None])
        if all(x is None for x in obj) and type is None:
            return Array(null(), len(obj), [None])
        if type is not None and (byte_width(type) or type.kind == "bool") \
                and type.kind not in ("decimal128", "fixed_size_binary"):
            valid = np.array([x is not None for x in obj], dtype=bool)
            base = bool_() if type.kind == "bool" else type
            dt = np.bool_ if type.kind == "bool" else _np_dtype(base)
            vals = np.array([0 if x is None else x for x in obj], dtype=dt)
            return array(vals, type, mask=None if valid.all() else ~valid)
        raise ArrowTypeError("array(): lists are built for binary(n), null and "
                             "fixed-width types only")
    a = np.asarray(obj)
    if a.ndim != 1:
        raise ArrowInvalid("only 1-D arrays convert")
    t = _from_np_dtype(a.dtype) if type is None else type
    valid = None
    if mask is not None:
        m = np.asarray(mask, dtype=bool)
        if len(m) != len(a):
            raise ArrowInvalid("mask length differs from the values'")
        valid = ~m
    vb = _validity_buffer(valid)
    nc = 0 if vb is None else int((~valid).sum())
    if t.kind == "bool":
        return Array(t, len(a), [vb, _pack(a.astype(bool))], nc)
    dt = _np_dtype(t)
    if dt is None:
        raise ArrowTypeError(f"array(): no NumPy conversion to {t}")
    if a.dtype != dt:
        a = a.astype(dt)
    return Array(t, len(a), [vb, np.ascontiguousarray(a)], nc)


# -- chunked arrays, batches and tables ----------------------------------------------


class ChunkedArray:
    __slots__ = ("chunks", "type")

    def __init__(self, chunks, type):
        self.chunks = list(chunks)
        self.type = type

    def __len__(self):
        return sum(len(c) for c in self.chunks)

    @property
    def null_count(self) -> int:
        return sum(c.null_count for c in self.chunks)

    @property
    def nbytes(self) -> int:
        return sum(c.nbytes for c in self.chunks)

    def combine_chunks(self) -> Array:
        if not self.chunks:
            return _empty(self.type)
        return concat_arrays(self.chunks)

    def to_pylist(self) -> list:
        out = []
        for c in self.chunks:
            out.extend(c.to_pylist())
        return out

    def slice(self, offset: int = 0, length=None):
        total = len(self)
        offset = max(0, min(int(offset), total))
        end = total if length is None else min(total, offset + max(0, int(length)))
        out, pos = [], 0
        for c in self.chunks:
            lo, hi = max(offset, pos), min(end, pos + len(c))
            if hi > lo:
                out.append(c.slice(lo - pos, hi - lo))
            pos += len(c)
        return ChunkedArray(out, self.type)

    def filter(self, mask):
        m = np.asarray(mask, dtype=bool)
        out, pos = [], 0
        for c in self.chunks:
            out.append(c.filter(m[pos : pos + len(c)]))
            pos += len(c)
        return ChunkedArray(out, self.type)

    def cast(self, target):
        return ChunkedArray([c.cast(target) for c in self.chunks], target)

    def __repr__(self):
        return f"<{self.type} chunked array of {len(self)} in {len(self.chunks)}>"


def chunked_array(arrays, type=None) -> ChunkedArray:
    arrays = [a if isinstance(a, Array) else array(a, type) for a in arrays]
    if type is None:
        if not arrays:
            raise ArrowInvalid("cannot construct ChunkedArray from empty list "
                               "without a type")
        type = arrays[0].type
    for a in arrays:
        if a.type != type:
            raise ArrowInvalid(f"chunk of {a.type} in a chunked array of {type}")
    return ChunkedArray(arrays, type)


class RecordBatch:
    """Columns of equal length under a schema (what an IPC stream holds)."""

    __slots__ = ("schema", "columns", "num_rows")

    def __init__(self, schema: Schema, columns, num_rows=None):
        self.schema = schema
        self.columns = list(columns)
        self.num_rows = (
            len(self.columns[0]) if num_rows is None and self.columns
            else int(num_rows or 0)
        )

    def to_pylist(self) -> list:
        names = self.schema.names
        cols = [c.to_pylist() for c in self.columns]
        return [dict(zip(names, row)) for row in zip(*cols)] if cols else [
            {} for _ in range(self.num_rows)
        ]


class Table:
    """Chunked columns of equal length under a schema."""

    __slots__ = ("schema", "columns", "_num_rows")

    def __init__(self, columns, schema: Schema, num_rows=None):
        self.columns = list(columns)
        self.schema = schema
        if num_rows is None:
            num_rows = len(self.columns[0]) if self.columns else 0
        self._num_rows = int(num_rows)
        for c in self.columns:
            if len(c) != self._num_rows:
                raise ArrowInvalid("table columns differ in length")

    @classmethod
    def from_batches(cls, batches, schema=None):
        batches = list(batches)
        if schema is None:
            if not batches:
                raise ArrowInvalid("from_batches of no batches needs a schema")
            schema = batches[0].schema
        cols = [
            ChunkedArray([b.columns[i] for b in batches], f.type)
            for i, f in enumerate(schema.fields)
        ]
        return cls(cols, schema, sum(b.num_rows for b in batches))

    @property
    def num_rows(self) -> int:
        return self._num_rows

    @property
    def column_names(self) -> list:
        return self.schema.names

    def column(self, i) -> ChunkedArray:
        if isinstance(i, str):
            idx = self.schema.get_field_index(i)
            if idx < 0:
                raise KeyError(f"Field \"{i}\" does not exist in schema")
            i = idx
        return self.columns[i]

    def select(self, names) -> "Table":
        idx = [self.schema.names.index(n) if isinstance(n, str) else n for n in names]
        return Table([self.columns[i] for i in idx],
                     Schema([self.schema.fields[i] for i in idx]), self._num_rows)

    def slice(self, offset: int = 0, length=None) -> "Table":
        offset = max(0, min(int(offset), self._num_rows))
        rest = self._num_rows - offset
        n = rest if length is None else max(0, min(int(length), rest))
        return Table([c.slice(offset, n) for c in self.columns], self.schema, n)

    def filter(self, mask) -> "Table":
        m = np.asarray(mask.to_pylist() if isinstance(mask, Array) else mask)
        m = np.asarray([bool(x) for x in m.tolist()] if m.dtype == object else m,
                       dtype=bool)
        if len(m) != self._num_rows:
            raise ArrowInvalid("filter mask length differs from the table's")
        return Table([c.filter(m) for c in self.columns], self.schema, int(m.sum()))

    def to_batches(self) -> list:
        """The table as record batches, split wherever any column's chunks
        split (pyarrow's TableBatchReader, no size cap)."""
        if not self.columns:
            return [RecordBatch(self.schema, [], self._num_rows)] if self._num_rows else []
        bounds = {0, self._num_rows}
        for c in self.columns:
            pos = 0
            for ch in c.chunks:
                pos += len(ch)
                bounds.add(pos)
        cuts = sorted(bounds)
        out = []
        for lo, hi in zip(cuts[:-1], cuts[1:]):
            cols = []
            for c in self.columns:
                pos = 0
                for ch in c.chunks:
                    if pos <= lo and hi <= pos + len(ch) and len(ch):
                        cols.append(ch.slice(lo - pos, hi - lo))
                        break
                    pos += len(ch)
            out.append(RecordBatch(self.schema, cols, hi - lo))
        return out

    def to_pylist(self) -> list:
        names = self.schema.names
        cols = [c.to_pylist() for c in self.columns]
        return [dict(zip(names, row)) for row in zip(*cols)] if cols else [
            {} for _ in range(self._num_rows)
        ]

    def equals(self, other) -> bool:
        return (
            isinstance(other, Table)
            and self.schema == other.schema
            and self.to_pylist() == other.to_pylist()
        )

    def __repr__(self):
        return f"<Table of {self._num_rows} rows: {self.schema.names}>"


def table(data, schema=None) -> Table:
    """A table from {name: Array | ChunkedArray | NumPy array} (every field
    nullable, as pyarrow's) or, with `schema`, a list of columns."""
    if isinstance(data, dict):
        names = list(data)
        cols = list(data.values())
    else:
        if schema is None:
            raise ArrowInvalid("table() of a list needs a schema")
        names = schema.names
        cols = list(data)
    out = []
    for c, name in zip(cols, names):
        if isinstance(c, ChunkedArray):
            out.append(c)
        elif isinstance(c, Array):
            out.append(ChunkedArray([c], c.type))
        else:
            a = array(c)
            out.append(ChunkedArray([a], a.type))
    if schema is None:
        schema = Schema([Field(n, c.type) for n, c in zip(names, out)])
    return Table(out, schema)
