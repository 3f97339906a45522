"""Marshal/unmarshal object model — explicit, reflection-free row building.

A copy of parquet_tpu/floor/interfaces.py.
The dataclass path in floor.api covers most uses; these builders are the
full-control analogue of the reference's interfaces package: user types
implement

    def marshal_parquet(self, obj: MarshalObject) -> None      # write side
    def unmarshal_parquet(self, obj: UnmarshalObject) -> None  # read side

and floor.Writer/Reader detect the methods (reference:
floor/interfaces/marshaller.go:13-175, unmarshaller.go:15-293; detection in
floor/writer.go:55-58 and floor/reader.go:88-90).

MarshalObject builds the wire-shaped nested record (LIST as
{"list": [{"element": v}, ...]}, MAP as {"key_value": [{"key": k,
"value": v}, ...]}) that FileWriter shreds directly; UnmarshalObject reads
the same shape from iter_rows(raw=True), accepting Athena's legacy
`bag`/`array_element` spelling on the way in (reference:
floor/reader.go:392-397, unmarshaller.go:193-208).
"""

from __future__ import annotations

import datetime as dt

from .time import Time

__all__ = [
    "FieldNotPresentError",
    "MarshalObject",
    "MarshalElement",
    "MarshalList",
    "MarshalMap",
    "UnmarshalObject",
    "UnmarshalElement",
    "UnmarshalList",
    "UnmarshalMap",
]


class FieldNotPresentError(KeyError):
    """Raised by UnmarshalObject.get_field for absent/null fields."""


_NANOS_PER = {"MILLIS": 1_000_000, "MICROS": 1_000, "NANOS": 1}


# -- write side ----------------------------------------------------------------


class MarshalElement:
    """Setter for one value slot (a field, list element, map key/value)."""

    __slots__ = ("_sink", "_key")

    def __init__(self, sink, key):
        self._sink = sink
        self._key = key

    def _set(self, v):
        self._sink[self._key] = v

    def set_int32(self, v: int):
        self._set(int(v))

    def set_int64(self, v: int):
        self._set(int(v))

    def set_float32(self, v: float):
        self._set(float(v))

    def set_float64(self, v: float):
        self._set(float(v))

    def set_bool(self, v: bool):
        self._set(bool(v))

    def set_byte_array(self, v: bytes):
        self._set(bytes(v))

    def set_string(self, v: str):
        self._set(str(v))

    def set_int96(self, v: bytes):
        if len(v) != 12:
            raise ValueError("INT96 takes exactly 12 bytes")
        self._set(bytes(v))

    def set_time(self, v: "Time | dt.time", unit: str = "NANOS"):
        """TIME value, stored in the column's unit (pass the schema's TIME
        unit: "MILLIS" | "MICROS" | "NANOS"). floor.Time keeps nanosecond
        precision; coarser units truncate."""
        if isinstance(v, Time):
            nanos = v.nanos
        else:
            nanos = (
                ((v.hour * 60 + v.minute) * 60 + v.second) * 1_000_000_000
                + v.microsecond * 1000
            )
        self._set(nanos // _NANOS_PER[unit])

    def group(self) -> "MarshalObject":
        obj = MarshalObject()
        self._set(obj.data)
        return obj

    def list(self) -> "MarshalList":
        lst = MarshalList()
        self._set(lst.data)
        return lst

    def map(self) -> "MarshalMap":
        m = MarshalMap()
        self._set(m.data)
        return m


class MarshalObject:
    """Builder for one record / nested group."""

    __slots__ = ("data",)

    def __init__(self):
        self.data: dict = {}

    def add_field(self, name: str) -> MarshalElement:
        return MarshalElement(self.data, name)


class MarshalList:
    """Builds the canonical 3-level LIST shape."""

    __slots__ = ("data",)

    def __init__(self):
        self.data = {"list": []}

    def add(self) -> MarshalElement:
        slot: dict = {}
        self.data["list"].append(slot)
        return MarshalElement(slot, "element")


class MarshalMap:
    """Builds the canonical MAP key_value shape."""

    __slots__ = ("data",)

    def __init__(self):
        self.data = {"key_value": []}

    def add(self) -> tuple[MarshalElement, MarshalElement]:
        slot: dict = {}
        self.data["key_value"].append(slot)
        return MarshalElement(slot, "key"), MarshalElement(slot, "value")


# -- read side -----------------------------------------------------------------


class UnmarshalElement:
    """Typed accessors over one decoded value slot."""

    __slots__ = ("_v",)

    def __init__(self, v):
        self._v = v

    def _require(self, types, what: str):
        if not isinstance(self._v, types):
            raise TypeError(f"field is {type(self._v).__name__}, not {what}")
        return self._v

    def int32(self) -> int:
        return int(self._require((int,), "int"))

    def int64(self) -> int:
        return int(self._require((int,), "int"))

    def float32(self) -> float:
        return float(self._require((int, float), "float"))

    def float64(self) -> float:
        return float(self._require((int, float), "float"))

    def bool_(self) -> bool:
        return self._require((bool,), "bool")

    def byte_array(self) -> bytes:
        v = self._v
        if isinstance(v, str):
            return v.encode("utf-8")
        return bytes(self._require((bytes, bytearray, memoryview), "bytes"))

    def string(self) -> str:
        v = self._v
        if isinstance(v, bytes):
            return v.decode("utf-8")
        return self._require((str,), "str")

    def time(self, unit: str = "NANOS") -> Time:
        """TIME column value; pass the schema's TIME unit
        ("MILLIS" | "MICROS" | "NANOS") so the stored int scales correctly."""
        return Time.from_nanos(int(self._require((int,), "int")) * _NANOS_PER[unit])

    def group(self) -> "UnmarshalObject":
        return UnmarshalObject(self._require((dict,), "group"))

    def list_(self) -> "UnmarshalList":
        return UnmarshalList(self._require((dict, list), "list"))

    def map_(self) -> "UnmarshalMap":
        return UnmarshalMap(self._require((dict,), "map"))

    def raw(self):
        return self._v


class UnmarshalObject:
    """Field access over one decoded record / nested group."""

    __slots__ = ("_row",)

    def __init__(self, row: dict):
        self._row = row

    def field_names(self):
        return list(self._row)

    def get_field(self, name: str) -> UnmarshalElement:
        v = self._row.get(name)
        if v is None:
            raise FieldNotPresentError(name)
        return UnmarshalElement(v)


class UnmarshalList:
    """Iterates LIST elements; accepts the canonical list/element shape and
    Athena's bag/array_element spelling (reference: floor/reader.go:392-397)."""

    __slots__ = ("_elems", "_key")

    def __init__(self, v):
        if isinstance(v, list):  # 2-level legacy list: elements directly
            self._elems, self._key = v, None
            return
        for wrapper, elem in (("list", "element"), ("bag", "array_element")):
            if wrapper in v:
                self._elems, self._key = v[wrapper], elem
                return
        raise TypeError(f"not a LIST shape: keys {sorted(v)}")

    def __len__(self):
        return len(self._elems)

    def __iter__(self):
        for e in self._elems:
            if self._key is not None and isinstance(e, dict):
                yield UnmarshalElement(e.get(self._key))
            else:
                yield UnmarshalElement(e)


class UnmarshalMap:
    """Iterates MAP entries as (key, value) UnmarshalElement pairs."""

    __slots__ = ("_pairs",)

    def __init__(self, v: dict):
        if "key_value" not in v:
            raise TypeError(f"not a MAP shape: keys {sorted(v)}")
        self._pairs = v["key_value"]

    def __len__(self):
        return len(self._pairs)

    def __iter__(self):
        for p in self._pairs:
            yield UnmarshalElement(p.get("key")), UnmarshalElement(p.get("value"))
