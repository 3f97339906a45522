"""floor: high-level object read/write (the reference's floor package).

A copy of parquet_tpu/floor/api.py, over the port's FileWriter.write_row and
FileReader.iter_rows: rows are built and read on the host. Reader keywords
go to FileReader, so on a machine without CUDA pass device="cpu" (the rows
never touch a device either way).

Write dataclass instances (or plain dicts) and read rows back as dataclass
instances, with logical-type conversions handled automatically:

    @dataclass
    class Trip:
        id: int
        vendor: Optional[str]
        ts: datetime.datetime
        tags: list[str]

    with floor.Writer("f.parquet", Trip) as w:   # schema auto-generated
        w.write(Trip(...))

    for trip in floor.Reader("f.parquet", Trip):
        ...

Equivalents: floor.NewFileWriter/Write (reference: floor/writer.go:18-70,
reflection marshalling :72-435), floor.NewFileReader/Next/Scan (reference:
floor/reader.go:17-94, reflection unmarshalling :96-436). Custom conversion
hooks: objects may define to_parquet()/from_parquet(row) (the
Marshaller/Unmarshaller interfaces, reference: floor/interfaces/).

Time handling (reference: floor/writer.go:147-212, floor/time.go):
datetime -> TIMESTAMP(MICROS) int64 (UTC), date -> DATE int32 days since
epoch, time -> TIME(MICROS) int64 micros since midnight.
"""

from __future__ import annotations

import dataclasses
import datetime as dt
import typing
import types as _types

from ..core.reader import FileReader
from ..core.writer import FileWriter
from .autoschema import schema_from_dataclass
from .interfaces import MarshalObject, UnmarshalObject
from .time import Time

__all__ = ["Writer", "Reader"]

_EPOCH_DATE = dt.date(1970, 1, 1)
_EPOCH_DT = dt.datetime(1970, 1, 1, tzinfo=dt.timezone.utc)


def _to_storage(v):
    """Python value -> parquet storage value (recursive)."""
    if v is None:
        return None
    if isinstance(v, Time):  # nanosecond TIME (reference: floor/time.go)
        return v.nanos
    if isinstance(v, dt.datetime):
        if v.tzinfo is None:
            v = v.replace(tzinfo=dt.timezone.utc)
        return int((v - _EPOCH_DT).total_seconds() * 1_000_000)
    if isinstance(v, dt.date):
        return (v - _EPOCH_DATE).days
    if isinstance(v, dt.time):
        return (
            v.hour * 3_600_000_000
            + v.minute * 60_000_000
            + v.second * 1_000_000
            + v.microsecond
        )
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return {
            (f.metadata.get("parquet", f.name) if f.metadata else f.name): _to_storage(
                getattr(v, f.name)
            )
            for f in dataclasses.fields(v)
        }
    if isinstance(v, (list, tuple)):
        return [_to_storage(x) for x in v]
    if isinstance(v, dict):
        return {k: _to_storage(x) for k, x in v.items()}
    return v


class Writer:
    """High-level writer: schema from the dataclass, rows from instances.

    `sink` and every keyword pass straight through to FileWriter: a path
    commits ATOMICALLY at close (tmp+rename — an exception mid-write never
    leaves a torn file), any ByteSink (sink/sink.py) plugs in directly,
    and `parallel=` engages the pqt-encode row-group pipeline — the
    high-level API gets the fast write path for free:

        with floor.Writer("f.parquet", Trip, parallel=True) as w:
            w.write_all(trips)
    """

    def __init__(self, sink, record_type=None, schema=None, **writer_kw):
        if schema is None:
            if record_type is None:
                raise TypeError("floor.Writer needs record_type or schema")
            schema = schema_from_dataclass(record_type)
        self.record_type = record_type
        self._w = FileWriter(sink, schema, **writer_kw)

    def write(self, obj) -> None:
        if hasattr(obj, "marshal_parquet"):  # Marshaller object model
            mo = MarshalObject()
            obj.marshal_parquet(mo)
            row = mo.data
        elif hasattr(obj, "to_parquet"):  # whole-object hook
            row = obj.to_parquet()
        elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
            row = _to_storage(obj)
        elif isinstance(obj, dict):
            row = _to_storage(obj)
        else:
            raise TypeError(
                f"floor: cannot write {type(obj).__name__} "
                "(expected dataclass, dict, or to_parquet())"
            )
        self._w.write_row(row)

    def write_all(self, objs) -> None:
        for o in objs:
            self.write(o)

    def close(self):
        return self._w.close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        # Delegate so an error ABORTS the underlying sink (temp file
        # deleted, destination untouched) instead of committing.
        return self._w.__exit__(exc_type, exc, tb)


class Reader:
    """High-level reader: rows -> dataclass instances (or dicts)."""

    def __init__(self, source, record_type=None, filters=None, **reader_kw):
        self.record_type = record_type
        self.filters = filters  # (column, op, value) conjunction; stats-pruned
        self._r = FileReader(source, **reader_kw)
        self._hints = (
            typing.get_type_hints(record_type) if record_type is not None else None
        )

    @property
    def schema(self):
        return self._r.schema

    @property
    def num_rows(self):
        return self._r.num_rows

    def __iter__(self):
        rt = self.record_type
        if rt is not None and hasattr(rt, "unmarshal_parquet"):
            # Unmarshaller object model: gets the wire-shaped raw row
            # (reference: floor/reader.go:88-90 + interfaces/unmarshaller.go).
            # Raw rows carry the wire shape, so only row-group PRUNING
            # applies here; exact row filtering needs the ergonomic domain.
            row_groups = (
                self._r.prune_row_groups(self.filters) if self.filters else None
            )
            for row in self._r.iter_rows(raw=True, row_groups=row_groups):
                inst = rt.__new__(rt)
                inst.unmarshal_parquet(UnmarshalObject(row))
                yield inst
            return
        for row in self._r.iter_rows(filters=self.filters):
            yield self._scan(row)

    def _scan(self, row: dict):
        rt = self.record_type
        if rt is None:
            return row
        if hasattr(rt, "from_parquet"):  # whole-object hook
            return rt.from_parquet(row)
        return _build(rt, row)

    def close(self):
        self._r.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def _build(cls, row: dict):
    """Construct a dataclass instance from a decoded row (recursive)."""
    kwargs = {}
    hints = typing.get_type_hints(cls)
    for f in dataclasses.fields(cls):
        col = f.metadata.get("parquet", f.name) if f.metadata else f.name
        kwargs[f.name] = _from_storage(hints[f.name], row.get(col))
    return cls(**kwargs)


def _from_storage(hint, v):
    if v is None:
        return None
    origin = typing.get_origin(hint)
    if origin in (typing.Union, _types.UnionType):
        args = [a for a in typing.get_args(hint) if a is not type(None)]
        return _from_storage(args[0], v) if len(args) == 1 else v
    if origin in (list, typing.List):
        (elem,) = typing.get_args(hint) or (None,)
        return [_from_storage(elem, x) for x in v] if elem else list(v)
    if origin in (dict, typing.Dict):
        kh, vh = typing.get_args(hint) or (None, None)
        return {k: _from_storage(vh, x) if vh else x for k, x in v.items()}
    if dataclasses.is_dataclass(hint):
        return _build(hint, v)
    # The assembler's ergonomic mode may already have produced rich values.
    if hint is dt.datetime:
        if isinstance(v, dt.datetime):
            return v
        return _EPOCH_DT + dt.timedelta(microseconds=int(v))
    if hint is dt.date:
        if isinstance(v, dt.date):
            return v
        return _EPOCH_DATE + dt.timedelta(days=int(v))
    if hint is Time:
        if isinstance(v, Time):
            return v
        if isinstance(v, dt.time):
            return Time.from_time(v)
        return Time.from_nanos(int(v))
    if hint is dt.time:
        if isinstance(v, Time):
            return v.to_time().replace(tzinfo=None)
        if isinstance(v, dt.time):
            return v
        micros = int(v)
        return dt.time(
            hour=micros // 3_600_000_000,
            minute=(micros // 60_000_000) % 60,
            second=(micros // 1_000_000) % 60,
            microsecond=micros % 1_000_000,
        )
    if hint is bytes and isinstance(v, str):
        return v.encode("utf-8")
    if hint is str and isinstance(v, bytes):
        return v.decode("utf-8")
    return v
