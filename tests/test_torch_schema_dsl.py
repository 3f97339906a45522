"""The port's schema DSL and builders against the JAX package's, on the CPU.

Every text of tests/test_dsl.py (the full taxi-shaped schema, the field-id,
DECIMAL and legacy-annotation texts, the validation cases, the sample
.schema corpus) and a schema for each of BASELINE.json's five configs
parse in both packages to the same Thrift elements, print to the same
text, and validate (lenient and strict) to the same verdict and message.
Malformed texts raise SchemaParseError with the same message in both. The
typed builders (required/optional/group/list_of/map_of/string/timestamp/
decimal/int_type/...) build the same Thrift elements in both packages, and
the port's DSL schema drives the port's FileWriter to the JAX writer's bytes.
"""

from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

from parquet_tpu.core.schema import SchemaError as JSchemaError  # noqa: E402
from parquet_tpu.core.writer import FileWriter as JWriter  # noqa: E402
from parquet_tpu.meta.parquet_types import FieldRepetitionType as JFRT  # noqa: E402
from parquet_tpu.meta.parquet_types import Type as JT  # noqa: E402
from parquet_tpu.schema import builder as jb  # noqa: E402
from parquet_tpu.schema import dsl as jdsl  # noqa: E402
from parquet_tpu.sink import MemorySink as JMemorySink  # noqa: E402

import parquet_tpu_torch  # noqa: E402
from parquet_tpu_torch import FileWriter  # noqa: E402
from parquet_tpu_torch.core.schema import SchemaError  # noqa: E402
from parquet_tpu_torch.meta.parquet_types import FieldRepetitionType as FRT  # noqa: E402
from parquet_tpu_torch.meta.parquet_types import Type as T  # noqa: E402
from parquet_tpu_torch.schema import builder as tb  # noqa: E402
from parquet_tpu_torch.schema import dsl as tdsl  # noqa: E402
from parquet_tpu_torch.sink import MemorySink  # noqa: E402

REPO = Path(__file__).resolve().parents[1]

BIG = """
message taxi {
  required int64 trip_id;
  optional binary vendor (STRING);
  optional double fare;
  optional boolean flagged;
  optional int32 day (DATE);
  optional int64 ts (TIMESTAMP(MICROS,true));
  optional int32 small (INT(8,false));
  optional fixed_len_byte_array(16) uid (UUID);
  optional int32 price (DECIMAL(9,2));
  optional group tags (LIST) {
    repeated group list {
      optional binary element (STRING);
    }
  }
  optional group attrs (MAP) {
    repeated group key_value {
      required binary key (STRING);
      optional int64 value;
    }
  }
  required group pos {
    required double lat;
    required double lon;
  }
}
"""

# tests/test_dsl.py's other texts: parse cases, then the validation cases
TEST_DSL_TEXTS = [
    "message m { required int32 a = 7; }",
    "message m { optional int64 d (DECIMAL(18,4)); }",
    "message m { optional binary s (UTF8); optional int64 t (TIMESTAMP_MILLIS); }",
    "message m { required int64 id; optional group l (LIST) "
    "{ repeated group list { optional int32 element; } } }",
    "message m { optional binary l (LIST); }",
    "message m { optional group l (LIST) { optional int32 list; } }",
    "message m { optional group l (LIST) { repeated group bag "
    "{ optional int32 array_element; } } }",
    "message m { optional group mp (MAP) { repeated group key_value "
    "{ required binary key; } } }",
    "message m { optional int32 s (UTF8); }",
    "message m { optional int32 d (DECIMAL(10,2)); }",
    "message m { optional fixed_len_byte_array(8) u (UUID); }",
]

# one schema a BASELINE.json config: PLAIN int64; hybrid int32; a dictionary
# string; a DELTA int64 TIMESTAMP; a nested LIST<int32>
BASELINE_TEXTS = [
    "message plain_int64 { required int64 value; }",
    "message hybrid_int32 { required int32 level (INT(32,true)); }",
    "message dict_string { required binary vendor (STRING); }",
    "message delta_ts { required int64 pickup (TIMESTAMP(MICROS,true)); }",
    "message nested_list { optional group items (LIST) "
    "{ repeated group list { required int32 element; } } }",
]

MORE_TEXTS = [
    "message m { required int32 t (TIME(MILLIS,true)); required int64 u (TIME(NANOS,false));"
    " required int64 v (TIMESTAMP(NANOS,false)); required int64 w (TIMESTAMP(MILLIS,true)); }",
    "message m { required int32 a (INT(16,false)); required int64 b (UINT_64);"
    " required int32 c (INT_8); required binary d (ENUM); required binary e (JSON);"
    " required binary f (BSON); required fixed_len_byte_array(2) g (FLOAT16);"
    " required fixed_len_byte_array(12) h (INTERVAL); required int96 i; required float j; }",
    "message m { optional group mp (MAP) = 3 { repeated group key_value (MAP_KEY_VALUE)"
    " { required binary key (STRING) = 4; optional group value { required int32 x; } } } }",
    "message m { required fixed_len_byte_array(9) d (DECIMAL(20)); }",
]

CORPUS = sorted((REPO / "parquet_tpu" / "schema" / "schema-files").glob("*.schema"))

TEXTS = (
    [("big", BIG)]
    + [(f"test_dsl_{i}", t) for i, t in enumerate(TEST_DSL_TEXTS)]
    + [(f"baseline_{i}", t) for i, t in enumerate(BASELINE_TEXTS)]
    + [(f"more_{i}", t) for i, t in enumerate(MORE_TEXTS)]
    + [(p.stem, p.read_text()) for p in CORPUS]
)

BAD_TEXTS = [
    "msg m { }",
    "message m { required int32 a }",
    "message m { int32 a; }",
    "message m { required badtype a; }",
    "message m { required int32 a (WHAT); }",
    "message m { required fixed_len_byte_array(0) a; }",
    "message m { required group g (LIST) { } }",
    "message m { required int32 a (DECIMAL(0)); }",
    "message m { required int32 a (INT(7,true)); }",
    "message m { required int64 t (TIME(WEEKS,true)); }",
    "message m {",
    "message m { required int32 a; } extra",
    "message m { required int32 a ! }",
    "message m { required int32 a (DECIMAL(3,4)); }",
    "message m { required int64 t (TIMESTAMP(MICROS,maybe)); }",
    "message m { required int32 a (INT(8,yes)); }",
    "",
]


def _thrift(schema) -> list[bytes]:
    return [e.dumps() for e in schema.to_thrift()]


def _verdict(fn, schema, err_types):
    try:
        fn(schema)
    except err_types as e:
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("label,text", TEXTS, ids=[t[0] for t in TEXTS])
def test_parse_print_and_validate_match_jax(label, text):
    js, ts = jdsl.parse_schema(text), tdsl.parse_schema(text)
    assert isinstance(ts, parquet_tpu_torch.Schema)
    assert _thrift(ts) == _thrift(js)
    assert [c.path for c in ts.leaves] == [c.path for c in js.leaves]
    assert [(c.max_def, c.max_rep) for c in ts.leaves] == [(c.max_def, c.max_rep) for c in js.leaves]
    printed = tdsl.schema_to_string(ts)
    assert printed == jdsl.schema_to_string(js)
    assert tdsl.schema_to_string(tdsl.parse_schema(printed)) == printed
    for t_fn, j_fn in ((tdsl.validate, jdsl.validate), (tdsl.validate_strict, jdsl.validate_strict)):
        assert _verdict(t_fn, ts, SchemaError) == _verdict(j_fn, js, JSchemaError)


@pytest.mark.parametrize("text", BAD_TEXTS)
def test_malformed_texts_raise_like_jax(text):
    with pytest.raises(jdsl.SchemaParseError) as j_err:
        jdsl.parse_schema(text)
    with pytest.raises(tdsl.SchemaParseError) as t_err:
        tdsl.parse_schema(text)
    assert str(t_err.value) == str(j_err.value)
    assert isinstance(t_err.value, ValueError)


def test_the_corpus_is_there():
    assert len(CORPUS) >= 7


def _built(b, TT, FRT):
    """One schema from every builder helper, with either package's builder."""
    point = b.group("pos", b.required("lat", TT.DOUBLE), b.required("lon", TT.DOUBLE),
                    repetition=FRT.REQUIRED)
    return b.message(
        b.required("id", TT.INT64),
        b.optional("name", b.string()),
        b.optional("ts", b.timestamp("millis", utc=False)),
        b.required("ts_ns", b.timestamp("nanos")),
        b.optional("day", b.date()),
        b.optional("tod_ms", b.time_of_day("millis")),
        b.optional("tod_us", b.time_of_day()),
        b.optional("price", b.decimal(9, 2)),
        b.optional("big", b.decimal(18, 4)),
        b.optional("huge", b.decimal(30, 5)),
        b.optional("fixed", b.decimal(5, 1, fixed_width=8)),
        b.optional("small", b.int_type(8, signed=False)),
        b.optional("wide", b.int_type(64)),
        b.repeated("many", TT.INT32),
        b.list_of("tags", b.optional("item", b.string())),
        b.list_of("req", b.required("element", TT.INT32), required_list=True),
        b.map_of("attrs", key=b.optional("k", b.string()), value=b.optional("v", TT.INT64)),
        point,
        b.optional("pos_copy", point),
        name="built",
    )


def test_builders_match_jax():
    js, ts = _built(jb, JT, JFRT), _built(tb, T, FRT)
    assert isinstance(ts, parquet_tpu_torch.Schema)
    assert _thrift(ts) == _thrift(js)
    assert tdsl.schema_to_string(ts) == jdsl.schema_to_string(js)
    tdsl.validate_strict(ts)
    assert tdsl.schema_to_string(tdsl.parse_schema(tdsl.schema_to_string(ts))) == \
        tdsl.schema_to_string(ts)


@pytest.mark.parametrize("bad", [
    lambda b: b.decimal(0), lambda b: b.decimal(5, 6), lambda b: b.decimal(20, fixed_width=4),
    lambda b: b.timestamp("weeks"), lambda b: b.time_of_day("days"),
])
def test_builder_errors_match_jax(bad):
    with pytest.raises(ValueError) as j_err:
        bad(jb)
    with pytest.raises(ValueError) as t_err:
        bad(tb)
    assert str(t_err.value) == str(j_err.value)


def test_builder_never_mutates_its_inputs():
    leaf = tb.optional("element", tb.string())
    tb.list_of("a", leaf)
    tb.map_of("m", key=leaf, value=leaf)
    assert leaf.name == "element" and leaf.repetition.name == "OPTIONAL"


def test_the_ports_dsl_schema_writes_the_jax_writers_bytes():
    text = BASELINE_TEXTS[0][:-1] + " required binary vendor (STRING); }"
    rng = np.random.default_rng(5)
    value = rng.integers(-(1 << 40), 1 << 40, 3000).astype(np.int64)
    vendor = np.array([f"v{i % 7}".encode() for i in range(3000)], dtype=object)
    out = []
    for W, M, parse in ((JWriter, JMemorySink, jdsl.parse_schema),
                        (FileWriter, MemorySink, parquet_tpu_torch.parse_schema)):
        sink = M()
        with W(sink, parse(text), codec="snappy") as w:
            w.write_column("value", value)
            w.write_column("vendor", vendor)
        out.append(sink.getvalue())
    assert out[0] == out[1]


def test_exports_are_the_references_names():
    import parquet_tpu

    for name in ("parse_schema", "schema_to_string", "validate", "validate_strict",
                 "SchemaParseError", "builder", "merge_files", "split_row_groups",
                 "SchemaError", "BufferedSink"):
        assert hasattr(parquet_tpu_torch, name), name
        assert hasattr(parquet_tpu, name), name
    assert parquet_tpu_torch.builder is tb
    assert parquet_tpu_torch.parse_schema is tdsl.parse_schema
