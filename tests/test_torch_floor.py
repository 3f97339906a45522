"""The port's floor API (parquet_tpu_torch.floor) against the JAX package's.

The same dataclass types (defined once per package, so each floor maps its
own floor.Time) and seeded instances go through both floor.Writer calls
and the files must be identical; both floor.Reader calls must give back
equal objects (floor.Time compared by nanoseconds and UTC flag), whole,
filtered and through to_parquet / from_parquet hooks.
schema_from_dataclass gives the same schema text in both, and refuses the
same hints. The Marshal/Unmarshal object model builds the same wire rows,
writes the same files and reads back the same objects. Every test runs
with PQT_VEC_ASSEMBLY / PQT_VEC_FILTER at 1 and at 0.
"""

import dataclasses
import datetime as dt
import io
import typing
from typing import Optional

import numpy as np
import pytest

pytest.importorskip("torch")

import parquet_tpu.kernels.device_ops  # noqa: E402,F401  (turns x64 on first)
from parquet_tpu import floor as jfloor  # noqa: E402
from parquet_tpu.schema.dsl import parse_schema as j_parse_schema  # noqa: E402
from parquet_tpu.schema.dsl import schema_to_string as j_schema_to_string  # noqa: E402
from parquet_tpu.sink import MemorySink as JMemorySink  # noqa: E402
from tests.test_torch_rows import engine, norm  # noqa: E402,F401

import parquet_tpu_torch  # noqa: E402
from parquet_tpu_torch import floor, parse_schema, schema_to_string  # noqa: E402
from parquet_tpu_torch.sink import MemorySink  # noqa: E402

UTC = dt.timezone.utc


def make_types(TimeCls):
    """The test's record types, annotated with one package's floor.Time."""

    @dataclasses.dataclass
    class Stop:
        name: str
        wait_s: Optional[float]

    @dataclasses.dataclass
    class Trip:
        trip_id: int
        vendor: Optional[str]
        pickup: dt.datetime
        day: dt.date
        clock: dt.time
        precise: TimeCls
        fare: Optional[float]
        paid: bool
        raw: bytes
        passengers: np.int32
        small: np.int16
        counter: np.uint64
        ratio: np.float32
        tags: list[str]
        scores: dict[str, int]
        stops: list[Stop]
        first: Optional[Stop]
        maybe_tags: Optional[list[Optional[str]]]
        renamed: int = dataclasses.field(default=0, metadata={"parquet": "zone_id"})

    return Trip, Stop


TRIP, STOP = make_types(floor.Time)
JTRIP, JSTOP = make_types(jfloor.Time)


def trips(TripCls, StopCls, TimeCls, n: int = 400, seed: int = 8):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        out.append(TripCls(
            trip_id=i,
            vendor=None if i % 9 == 0 else f"v{int(rng.integers(0, 5))}",
            pickup=dt.datetime(2024, 5, 1, tzinfo=UTC) + dt.timedelta(seconds=int(rng.integers(0, 10**7))),
            day=dt.date(2024, 1, 1) + dt.timedelta(days=int(rng.integers(0, 366))),
            clock=dt.time(int(rng.integers(0, 24)), int(rng.integers(0, 60)), int(rng.integers(0, 60)),
                          int(rng.integers(0, 10**6))),
            precise=TimeCls.from_nanos(int(rng.integers(0, 86_400 * 10**9))),
            fare=None if i % 7 == 0 else round(float(rng.uniform(2, 90)), 2),
            paid=bool(i % 3),
            raw=bytes(int(b) for b in rng.integers(0, 256, int(rng.integers(0, 5)))),
            passengers=np.int32(rng.integers(1, 6)),
            small=np.int16(rng.integers(-300, 300)),
            counter=np.uint64(int(rng.integers(0, 2**62)) * 3),
            ratio=np.float32(rng.standard_normal()),
            tags=[f"t{int(t)}" for t in rng.integers(0, 9, int(rng.integers(0, 4)))],
            scores={f"k{int(k)}": int(rng.integers(0, 100)) for k in rng.integers(0, 5, int(rng.integers(0, 3)))},
            stops=[StopCls(f"s{j}", None if j % 2 else float(j)) for j in range(int(rng.integers(0, 3)))],
            first=None if i % 4 == 0 else StopCls("origin", 1.5),
            maybe_tags=None if i % 5 == 0 else [None if k % 3 == 0 else f"m{k}" for k in range(i % 4)],
            renamed=int(rng.integers(0, 260)),
        ))
    return out


def write_both(opts=None):
    opts = opts or {}
    jsink, sink = JMemorySink(), MemorySink()
    with jfloor.Writer(jsink, JTRIP, **opts) as w:
        w.write_all(trips(JTRIP, JSTOP, jfloor.Time))
    with floor.Writer(sink, TRIP, **opts) as w:
        w.write_all(trips(TRIP, STOP, floor.Time))
    return jsink.getvalue(), sink.getvalue()


def as_plain(obj, items=False):
    """A dataclass instance as nested Python values, comparable across the
    two packages' types, each scalar with its type (tests.test_torch_rows.
    norm). `items=True` takes NumPy scalars as the Python values that both
    packages' readers give back for them (the written objects' np.int32
    fields and the like)."""
    if dataclasses.is_dataclass(obj):
        return {f.name: as_plain(getattr(obj, f.name), items) for f in dataclasses.fields(obj)}
    if isinstance(obj, list):
        return [as_plain(v, items) for v in obj]
    if isinstance(obj, dict):
        return {k: as_plain(v, items) for k, v in obj.items()}
    if items and isinstance(obj, np.generic):
        return norm(obj.item())
    return norm(obj)


def test_schema_from_dataclass_matches_jax():
    assert schema_to_string(floor.schema_from_dataclass(TRIP)) == j_schema_to_string(
        jfloor.schema_from_dataclass(JTRIP))
    assert schema_to_string(floor.schema_from_dataclass(TRIP, name="trips")) == j_schema_to_string(
        jfloor.schema_from_dataclass(JTRIP, name="trips"))


@pytest.mark.parametrize("hint", [complex, typing.Union[int, str], set[int]], ids=str)
def test_schema_from_dataclass_refuses_like_jax(hint):
    Bad = dataclasses.make_dataclass("Bad", [("x", hint)])
    with pytest.raises(floor.AutoSchemaError) as te:
        floor.schema_from_dataclass(Bad)
    with pytest.raises(jfloor.AutoSchemaError) as je:
        jfloor.schema_from_dataclass(Bad)
    assert str(te.value) == str(je.value)
    with pytest.raises(floor.AutoSchemaError):
        floor.schema_from_dataclass(int)


@pytest.mark.parametrize("opts", [{}, {"codec": "snappy", "parallel": True},
                                  {"codec": "gzip", "data_page_version": 2, "write_page_index": True}],
                         ids=["default", "snappy-parallel", "gzip-v2-index"])
def test_writer_files_match_jax(opts):
    jraw, raw = write_both(opts)
    assert raw == jraw


def test_reader_objects_match_jax():
    jraw, raw = write_both()
    with jfloor.Reader(io.BytesIO(jraw), JTRIP) as jr:
        want = [as_plain(t) for t in jr]
    with floor.Reader(raw, TRIP, device="cpu") as r:
        got = [as_plain(t) for t in r]
        assert r.num_rows == 400 and r.schema.column(("zone_id",)).is_leaf
    assert got == want
    assert got == [as_plain(t, items=True) for t in trips(TRIP, STOP, floor.Time)]


@pytest.mark.parametrize("filters", [[("trip_id", "<", 50)], [("vendor", "==", "v2"), ("paid", "==", True)],
                                     [[("fare", ">", 80.0)], [("zone_id", "<", 10)]]], ids=str)
def test_filtered_reader_matches_jax(filters):
    jraw, raw = write_both()
    with jfloor.Reader(io.BytesIO(jraw), JTRIP, filters=filters) as jr:
        want = [as_plain(t) for t in jr]
    with floor.Reader(raw, TRIP, filters=filters, device="cpu") as r:
        got = [as_plain(t) for t in r]
    assert got == want and 0 < len(got) < 400


def test_dict_rows_and_hooks_match_jax():
    class Hooked:
        def __init__(self, a, b):
            self.a, self.b = a, b

        def to_parquet(self):
            return {"a": self.a, "b": self.b}

        @classmethod
        def from_parquet(cls, row):
            return cls(row["a"], row["b"])

    dsl = "message m { required int64 a; optional binary b (STRING); }"
    objs = [Hooked(i, None if i % 3 else f"b{i}") for i in range(50)] + [{"a": 99, "b": "dict row"}]
    outs = []
    for fl, parse, sink in ((jfloor, j_parse_schema, JMemorySink()), (floor, parse_schema, MemorySink())):
        with fl.Writer(sink, schema=parse(dsl)) as w:
            w.write_all(objs)
        outs.append(sink.getvalue())
    assert outs[0] == outs[1]
    with floor.Reader(outs[1], Hooked, device="cpu") as r:
        got = [(h.a, h.b) for h in r]
    with jfloor.Reader(io.BytesIO(outs[0]), Hooked) as jr:
        want = [(h.a, h.b) for h in jr]
    assert got == want and got[-1] == (99, "dict row")
    with floor.Reader(outs[1], device="cpu") as r:
        assert list(r)[-1] == {"a": 99, "b": "dict row"}
    with pytest.raises(TypeError, match="cannot write int"):
        floor.Writer(MemorySink(), schema=parse_schema(dsl)).write(42)
    with pytest.raises(TypeError):
        floor.Writer(MemorySink())


# -- the Marshal/Unmarshal object model -----------------------------------------

RECORD_DSL = """message record {
  required int64 rid;
  required binary name (STRING);
  optional group tags (LIST) { repeated group list { optional binary element (STRING); } }
  optional group attrs (MAP) {
    repeated group key_value { required binary key (STRING); optional int64 value; }
  }
  optional group pos { required double x; required float y; }
  optional int64 at (TIME(NANOS, true));
  optional int32 small;
  optional boolean ok;
  optional binary blob;
  optional int96 legacy;
}"""


def make_record(fl):
    class Record:
        def __init__(self, rid=None, name=None, tags=None, attrs=None, pos=None, at=None,
                     small=None, ok=None, blob=None, legacy=None):
            self.rid, self.name, self.tags, self.attrs = rid, name, tags, attrs
            self.pos, self.at, self.small, self.ok, self.blob, self.legacy = pos, at, small, ok, blob, legacy

        def marshal_parquet(self, obj):
            obj.add_field("rid").set_int64(self.rid)
            obj.add_field("name").set_string(self.name)
            lst = obj.add_field("tags").list()
            for t in self.tags:
                lst.add().set_string(t)
            m = obj.add_field("attrs").map()
            for k, v in self.attrs.items():
                ke, ve = m.add()
                ke.set_string(k)
                ve.set_int64(v)
            g = obj.add_field("pos").group()
            g.add_field("x").set_float64(self.pos[0])
            g.add_field("y").set_float32(self.pos[1])
            obj.add_field("at").set_time(self.at, unit="NANOS")
            obj.add_field("small").set_int32(self.small)
            obj.add_field("ok").set_bool(self.ok)
            obj.add_field("blob").set_byte_array(self.blob)
            obj.add_field("legacy").set_int96(self.legacy)

        def unmarshal_parquet(self, obj):
            self.rid = obj.get_field("rid").int64()
            self.name = obj.get_field("name").string()
            self.tags = [e.string() for e in obj.get_field("tags").list_()]
            self.attrs = {k.string(): v.int64() for k, v in obj.get_field("attrs").map_()}
            g = obj.get_field("pos").group()
            self.pos = (g.get_field("x").float64(), g.get_field("y").float32())
            self.at = obj.get_field("at").time(unit="NANOS")
            self.small = obj.get_field("small").int32()
            self.ok = obj.get_field("ok").bool_()
            self.blob = obj.get_field("blob").byte_array()
            self.legacy = obj.get_field("legacy").raw()
            self.fields = sorted(obj.field_names())

        def plain(self):
            return norm([self.rid, self.name, self.tags, self.attrs, self.pos, self.at,
                         self.small, self.ok, self.blob, self.legacy])

    return Record


def records(Record, TimeCls):
    rng = np.random.default_rng(12)
    return [Record(i, f"n{i}", [f"t{j}" for j in range(i % 3)], {f"k{j}": j * i for j in range(i % 2)},
                   (float(i) / 3, float(np.float32(i / 7))), TimeCls.from_nanos(i * 1_000_000_007),
                   int(rng.integers(-9, 9)), bool(i % 2), bytes([i % 256, 7]),
                   bytes(int(b) for b in rng.integers(0, 256, 12)))
            for i in range(120)]


def test_marshal_objects_write_and_read_like_jax():
    JRec, Rec = make_record(jfloor), make_record(floor)
    jrows, rows = [], []
    for r in records(JRec, jfloor.Time):
        mo = jfloor.MarshalObject()
        r.marshal_parquet(mo)
        jrows.append(mo.data)
    for r in records(Rec, floor.Time):
        mo = floor.MarshalObject()
        r.marshal_parquet(mo)
        rows.append(mo.data)
    assert norm(rows) == norm(jrows)
    outs = []
    for fl, parse, sink, recs in ((jfloor, j_parse_schema, JMemorySink(), records(JRec, jfloor.Time)),
                                  (floor, parse_schema, MemorySink(), records(Rec, floor.Time))):
        with fl.Writer(sink, schema=parse(RECORD_DSL)) as w:
            w.write_all(recs)
        outs.append(sink.getvalue())
    assert outs[0] == outs[1]
    with jfloor.Reader(io.BytesIO(outs[0]), JRec) as jr:
        want = [r.plain() for r in jr]
    with floor.Reader(outs[1], Rec, device="cpu") as r:
        back = list(r)
    assert [b.plain() for b in back] == want
    assert [b.plain() for b in back] == [r.plain() for r in records(Rec, floor.Time)]
    assert back[0].fields == sorted(
        ["rid", "name", "tags", "attrs", "pos", "at", "small", "ok", "blob", "legacy"])
    # pruning only, as in the reference: raw rows carry the wire shape
    with floor.Reader(outs[1], Rec, filters=[("rid", ">", 1000)], device="cpu") as r:
        assert len(list(r)) == 0


def test_unmarshal_elements_match_jax():
    row = {"a": 1, "b": None, "s": b"x\xc3\xa9", "l": {"list": [{"element": 3}, {"element": None}]},
           "bag": {"bag": [{"array_element": 5}]},
           "m": {"key_value": [{"key": b"k", "value": 2}]}, "t": 5_000, "f": 1.5}
    for fl in (floor, jfloor):
        obj = fl.UnmarshalObject(row)
        with pytest.raises(fl.FieldNotPresentError):
            obj.get_field("b")
        with pytest.raises(fl.FieldNotPresentError):
            obj.get_field("zz")
        with pytest.raises(TypeError):
            obj.get_field("s").int64()
    t, j = floor.UnmarshalObject(row), jfloor.UnmarshalObject(row)
    assert t.get_field("s").string() == j.get_field("s").string() == "xé"
    assert [e.raw() for e in t.get_field("l").list_()] == [e.raw() for e in j.get_field("l").list_()]
    assert [e.int64() for e in t.get_field("bag").list_()] == [e.int64() for e in j.get_field("bag").list_()]
    assert ([(k.byte_array(), v.int64()) for k, v in t.get_field("m").map_()]
            == [(k.byte_array(), v.int64()) for k, v in j.get_field("m").map_()])
    assert norm(t.get_field("t").time("MICROS")) == norm(j.get_field("t").time("MICROS"))
    assert t.get_field("f").float64() == j.get_field("f").float64()
    assert sorted(t.field_names()) == sorted(j.field_names())
    for fl in (floor, jfloor):
        with pytest.raises(ValueError):
            fl.MarshalObject().add_field("x").set_int96(b"short")


def test_floor_exported_from_the_package():
    assert parquet_tpu_torch.floor is floor
    assert floor.Writer.__module__.startswith("parquet_tpu_torch.")
    assert floor.Reader.__module__.startswith("parquet_tpu_torch.")
