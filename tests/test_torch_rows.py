"""Host rows: the port's iter_rows, record assembly and value conversions
against the JAX package.

The same files go through the JAX package's FileReader.iter_rows and the
port's (`device="cpu"`; rows never touch a device): all 29 golden files,
the port's synth writer over its type zoo (every numeric type and byte
arrays, PLAIN, dictionary, DELTA and BYTE_STREAM_SPLIT encodings, optional
columns, LISTs with null elements, several codecs), and nested LIST, MAP
and struct schemas written from seeded rows, raw and ergonomic, whole and
projected. Every test runs under both engines (PQT_VEC_ASSEMBLY and
PQT_VEC_FILTER at 1 and at 0). Rows compare exactly (NaN equal to NaN; the
two packages' floor.Time by its nanoseconds and UTC flag): no arithmetic
happens on the way. convert_logical / convert_to_storage are held against
the JAX functions on INT96, DECIMAL, DATE, TIME and TIMESTAMP units, UUID,
JSON and unsigned columns.
"""

import datetime as dt
import decimal
import io
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

import parquet_tpu.kernels.device_ops  # noqa: E402,F401  (turns x64 on first)
from parquet_tpu.core import assembly as jasm  # noqa: E402
from parquet_tpu.core.reader import FileReader as JReader  # noqa: E402
from parquet_tpu.core.writer import FileWriter as JWriter  # noqa: E402
from parquet_tpu.floor.time import Time as JTime  # noqa: E402
from parquet_tpu.ops import levels as jlevels  # noqa: E402
from parquet_tpu.schema.dsl import parse_schema as j_parse_schema  # noqa: E402
from parquet_tpu.sink import MemorySink as JMemorySink  # noqa: E402
from tests.test_torch_mixed import zstd  # noqa: E402,F401

import parquet_tpu_torch  # noqa: E402
from parquet_tpu_torch import FileReader, parse_schema  # noqa: E402
from parquet_tpu_torch.core import assembly as tasm  # noqa: E402
from parquet_tpu_torch.core.assembly import AssemblyError, RecordAssembler  # noqa: E402
from parquet_tpu_torch.floor.time import Time  # noqa: E402
from parquet_tpu_torch.meta.parquet_types import CompressionCodec as C  # noqa: E402
from parquet_tpu_torch.meta.parquet_types import Encoding as E  # noqa: E402
from parquet_tpu_torch.meta.parquet_types import Type as T  # noqa: E402
from parquet_tpu_torch.ops import levels as tlevels  # noqa: E402
from parquet_tpu_torch.testing.synth import ColumnSpec, write_file  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
GOLDEN = Path(__file__).parent / "golden" / "data"
GOLDEN_FILES = sorted(p.name for p in GOLDEN.glob("*.parquet"))


@pytest.fixture(params=["1", "0"], ids=["vec", "scalar"], autouse=True)
def engine(request, monkeypatch):
    monkeypatch.setenv("PQT_VEC_ASSEMBLY", request.param)
    monkeypatch.setenv("PQT_VEC_FILTER", request.param)
    return request.param


def norm(x):
    """A value in a form `==` compares exactly, type and all: each scalar
    leaf as (type name, value), so 1, 1.0, np.int32(1) and Decimal(1)
    differ; NaN equal to NaN; a Decimal by its digits and a datetime by its
    repr (tzinfo included); the two packages' floor.Time as one type, by
    (nanos, utc); containers element-wise (a tuple tagged as one)."""
    if isinstance(x, (Time, JTime)):
        return ("Time", x.nanos, x.utc)
    if isinstance(x, dict):
        return {k: norm(v) for k, v in x.items()}
    if isinstance(x, list):
        return [norm(v) for v in x]
    if isinstance(x, tuple):
        return ("tuple", [norm(v) for v in x])
    if isinstance(x, np.datetime64):
        return ("datetime64", str(x.dtype), int(x.astype("datetime64[ns]").astype(np.int64)))
    if isinstance(x, (float, np.floating)) and math.isnan(x):
        return (type(x).__name__, "nan")
    if isinstance(x, (decimal.Decimal, dt.date, dt.time, dt.timedelta)):
        return (type(x).__name__, repr(x))
    return (type(x).__name__, x)


def jax_rows(raw_bytes, **kw):
    read = kw.pop("read", {})
    with JReader(io.BytesIO(raw_bytes), **read) as r:
        return norm(list(r.iter_rows(**kw)))


def port_rows(raw_bytes, **kw):
    read = kw.pop("read", {})
    with FileReader(raw_bytes, device="cpu", **read) as r:
        return norm(list(r.iter_rows(**kw)))


def outcome(fn, *args, **kw):
    """("ok", rows) or ("error", exception class name)."""
    try:
        return "ok", fn(*args, **kw)
    except Exception as e:  # noqa: BLE001  (compared across packages)
        return "error", type(e).__name__


# -- the golden files -----------------------------------------------------------


@pytest.mark.parametrize("raw", [False, True], ids=["rows", "raw"])
@pytest.mark.parametrize("name", GOLDEN_FILES)
def test_golden_rows_match_jax(name, raw, zstd):  # noqa: F811
    data = (GOLDEN / name).read_bytes()
    want = outcome(jax_rows, data, raw=raw)
    got = outcome(port_rows, data, raw=raw)
    assert got == want


@pytest.mark.parametrize("name", GOLDEN_FILES)
def test_golden_iteration_and_row_groups_match_jax(name, zstd):  # noqa: F811
    data = (GOLDEN / name).read_bytes()

    def jax_iter():
        with JReader(io.BytesIO(data)) as r:
            return norm(list(r)), r.num_row_groups

    def port_iter():
        with FileReader(data, device="cpu") as r:
            return norm(list(r)), len(list(r.iter_row_groups()))

    assert outcome(port_iter) == outcome(jax_iter)


# -- the synth type zoo ---------------------------------------------------------


def zoo_specs(n: int = 3000, seed: int = 5):
    rng = np.random.default_rng(seed)
    valid = rng.random(n) > 0.2
    words = [f"w{i}".encode() for i in range(40)]
    from parquet_tpu_torch.core.arrays import ByteArrayData

    dict_words = ByteArrayData.from_list(words)
    lens = rng.integers(0, 5, n)
    lens[rng.random(n) < 0.1] = 0
    return [
        ColumnSpec("i32", T.INT32, values=rng.integers(-(2**31), 2**31, n).astype(np.int32)),
        ColumnSpec("i64_delta", T.INT64, encoding=E.DELTA_BINARY_PACKED, codec=C.GZIP,
                   values=np.cumsum(rng.integers(-50, 50, n)).astype(np.int64)),
        ColumnSpec("f32_bss", T.FLOAT, encoding=E.BYTE_STREAM_SPLIT,
                   values=rng.standard_normal(n).astype(np.float32)),
        ColumnSpec("f64_opt", T.DOUBLE, codec=C.SNAPPY, valid=valid,
                   values=np.where(rng.random(int(valid.sum())) < 0.05, np.nan,
                                   rng.standard_normal(int(valid.sum())))),
        ColumnSpec("d32", T.INT32, encoding=E.RLE_DICTIONARY, page_version=2,
                   dictionary=np.arange(9, dtype=np.int32) * 11,
                   indices=rng.integers(0, 9, n).astype(np.int32)),
        ColumnSpec("str_dict", T.BYTE_ARRAY, encoding=E.RLE_DICTIONARY, utf8=True, valid=valid,
                   dictionary=dict_words,
                   indices=rng.integers(0, 40, int(valid.sum())).astype(np.int32)),
        ColumnSpec("bin", T.BYTE_ARRAY, encoding=E.DELTA_LENGTH_BYTE_ARRAY,
                   values=ByteArrayData.from_list([bytes(rng.integers(0, 256, int(k)).astype(np.uint8))
                                                   for k in rng.integers(0, 6, n)])),
        ColumnSpec("tags", T.INT64, list_lengths=lens,
                   values=rng.integers(0, 100, int(lens.sum())).astype(np.int64),
                   element_valid=rng.random(int(lens.sum())) > 0.15),
        ColumnSpec("names", T.BYTE_ARRAY, utf8=True, list_lengths=np.roll(lens, 7),
                   values=ByteArrayData.from_list([words[int(k)] for k in
                                                   rng.integers(0, 40, int(lens.sum()))])),
    ]


@pytest.fixture(scope="module")
def zoo_file():
    buf = io.BytesIO()
    write_file(buf, zoo_specs(), row_group_rows=1100, page_bytes=4096)
    return buf.getvalue()


@pytest.mark.parametrize("raw", [False, True], ids=["rows", "raw"])
@pytest.mark.parametrize("columns", [None, ["i32", "tags"], ["names", "f64_opt", "bin"]],
                         ids=["all", "flat+list", "mixed"])
def test_synth_zoo_rows_match_jax(zoo_file, raw, columns):
    read = {"columns": columns} if columns else {}
    want = jax_rows(zoo_file, raw=raw, read=read)
    assert len(want) == 3000
    assert port_rows(zoo_file, raw=raw, read=read) == want


def test_synth_zoo_row_groups_subset_match_jax(zoo_file):
    assert port_rows(zoo_file, row_groups=[2, 0]) == jax_rows(zoo_file, row_groups=[2, 0])


def test_engine_counts_follow_the_switch(zoo_file, engine):
    parquet_tpu_torch.reset_row_counts()
    with FileReader(zoo_file, device="cpu") as r:
        n = sum(1 for _ in r.iter_rows())
    c = parquet_tpu_torch.row_counts()
    groups = 3
    if engine == "1":
        assert c.get("assemble_vec") == groups and not c.get("assemble_cursor")
        assert c.get("rows_assembled_vec") == n == 3000
    else:
        assert c.get("assemble_cursor") == groups and not c.get("assemble_vec")
        assert c.get("rows_assembled_scalar") == n == 3000


# -- nested schemas -------------------------------------------------------------

NESTED_DSL = """message m {
  required int64 id;
  optional group tags (LIST) { repeated group list { optional binary element (STRING); } }
  required group req_list (LIST) { repeated group list { required int32 element; } }
  optional group attrs (MAP) {
    repeated group key_value { required binary key (STRING); optional int64 value; }
  }
  optional group pt { required double x; optional group inner { optional int32 z; repeated int32 r; } }
  repeated group events { required int64 at; optional binary kind (STRING); }
  optional group grid (LIST) {
    repeated group list { optional group element (LIST) { repeated group list { optional int32 element; } } }
  }
  repeated binary legacy;
}"""


def nested_rows(n: int, seed: int):
    rng = np.random.default_rng(seed)

    def maybe(p, v):
        return None if rng.random() < p else v

    rows = []
    for i in range(n):
        k = int(rng.integers(0, 4))
        rows.append({
            "id": i,
            "tags": maybe(0.1, [maybe(0.2, f"t{int(rng.integers(0, 9))}") for _ in range(k)]),
            "req_list": [int(x) for x in rng.integers(-5, 5, int(rng.integers(0, 3)))],
            "attrs": maybe(0.15, {f"k{j}": maybe(0.3, int(rng.integers(0, 99)))
                                  for j in range(int(rng.integers(0, 3)))}),
            "pt": maybe(0.2, {"x": float(rng.standard_normal()),
                              "inner": maybe(0.3, {"z": maybe(0.5, i),
                                                   "r": [int(x) for x in
                                                         rng.integers(0, 9, int(rng.integers(0, 3)))]})}),
            "events": [{"at": int(rng.integers(0, 10**9)), "kind": maybe(0.4, "ev")}
                       for _ in range(int(rng.integers(0, 3)))],
            "grid": maybe(0.1, [maybe(0.2, [maybe(0.2, int(rng.integers(0, 50)))
                                            for _ in range(int(rng.integers(0, 3)))])
                                for _ in range(int(rng.integers(0, 3)))]),
            "legacy": [bytes([int(b)]) for b in rng.integers(0, 256, int(rng.integers(0, 3)))],
        })
    return rows


@pytest.fixture(scope="module")
def nested_file():
    sink = JMemorySink()
    w = JWriter(sink, j_parse_schema(NESTED_DSL), max_page_size=2048, row_group_size=40_000)
    w.write_rows(nested_rows(2500, 11))
    w.close()
    return sink.getvalue()


NESTED_PROJECTIONS = [None, ["tags"], ["attrs", "id"], ["pt.inner"], ["pt.x", "events.kind"],
                      ["grid"], ["legacy", "req_list"], ["attrs.key_value.key"]]


@pytest.mark.parametrize("raw", [False, True], ids=["rows", "raw"])
@pytest.mark.parametrize("columns", NESTED_PROJECTIONS, ids=[str(c) for c in NESTED_PROJECTIONS])
def test_nested_rows_match_jax(nested_file, raw, columns):
    read = {"columns": columns} if columns else {}
    want = jax_rows(nested_file, raw=raw, read=read)
    assert len(want) == 2500
    assert port_rows(nested_file, raw=raw, read=read) == want


def test_nested_file_has_several_row_groups(nested_file):
    with FileReader(nested_file, device="cpu") as r:
        assert r.num_row_groups > 1


@pytest.mark.parametrize("raw", [False, True], ids=["rows", "raw"])
def test_record_assembler_engines_agree(nested_file, raw):
    with FileReader(nested_file, device="cpu") as r, JReader(io.BytesIO(nested_file)) as jr:
        for i in range(r.num_row_groups):
            chunks = r.read_row_group(i)
            scalar = norm(list(RecordAssembler(r.schema, chunks, raw=raw, engine="scalar")))
            vec = norm(list(RecordAssembler(r.schema, chunks, raw=raw, engine="vec")))
            jchunks = jr.read_row_group(i)
            want = norm(list(jasm.RecordAssembler(jr.schema, jchunks, raw=raw, engine="scalar")))
            assert scalar == vec == want


def test_scalar_walk_raises_typed_on_short_values(nested_file):
    with FileReader(nested_file, device="cpu") as r:
        chunks = r.read_row_group(0)
        cd = chunks[("id",)]
        cd.values = cd.values[:-1]
        with pytest.raises(AssemblyError):
            list(RecordAssembler(r.schema, chunks, engine="scalar"))


# -- value conversions ----------------------------------------------------------

LOGICAL_DSL = """message m {
  required int96 t96;
  required int32 d32 (DECIMAL(9, 2));
  required int64 d64 (DECIMAL(18, 4));
  required fixed_len_byte_array(7) dfl (DECIMAL(16, 3));
  required binary dba (DECIMAL(30, 5));
  required int32 day (DATE);
  required int32 tms (TIME(MILLIS, true));
  required int64 tus (TIME(MICROS, false));
  required int64 tns (TIME(NANOS, true));
  required int64 tsms (TIMESTAMP(MILLIS, true));
  required int64 tsus (TIMESTAMP(MICROS, false));
  required int64 tsns (TIMESTAMP(NANOS, true));
  required fixed_len_byte_array(16) id (UUID);
  required binary doc (JSON);
  required binary name (STRING);
  required int32 u32 (INT(32, false));
  required int64 u64 (INT(64, false));
  required int32 u8 (INT(8, false));
  required int64 plain;
}"""


def storage_values(rng, name):
    if name == "t96":
        return [bytes(int(x) for x in rng.integers(0, 256, 8)) + int(d).to_bytes(4, "little")
                for d in rng.integers(2_400_000, 2_500_000, 20)]
    if name == "dfl":
        return [int(v).to_bytes(7, "big", signed=True) for v in rng.integers(-(2**40), 2**40, 20)]
    if name == "dba":
        return [int(v).to_bytes(9, "big", signed=True) for v in rng.integers(-(2**62), 2**62, 20)] + [b""]
    if name == "id":
        return [bytes(int(x) for x in rng.integers(0, 256, 16)) for _ in range(20)]
    if name in ("doc", "name"):
        return ['{"a": 1}'.encode(), "é ü".encode(), b"\xff\xfe"]
    if name in ("tms",):
        return [int(v) for v in rng.integers(0, 86_400_000, 20)]
    if name in ("tus",):
        return [int(v) for v in rng.integers(0, 86_400_000_000, 20)]
    if name in ("tns",):
        return [int(v) for v in rng.integers(0, 86_400_000_000_000, 20)]
    if name == "u32":
        return [int(v) for v in rng.integers(-(2**31), 2**31, 20)]
    if name == "day":  # within datetime.date's range
        return [int(v) for v in rng.integers(-700_000, 2_900_000, 20)]
    if name in ("u8", "d32"):
        return [int(v) for v in rng.integers(-(2**20), 2**20, 20)]
    if name == "tsms":
        return [int(v) for v in rng.integers(-(2**45), 2**45, 20)]
    if name == "tsus":
        return [int(v) for v in rng.integers(-(2**55), 2**55, 20)]
    return [int(v) for v in rng.integers(-(2**62), 2**62, 20)] + [2**62 * 3]


def test_convert_logical_matches_jax():
    rng = np.random.default_rng(3)
    ts, js = parse_schema(LOGICAL_DSL), j_parse_schema(LOGICAL_DSL)
    checked = 0
    for leaf in ts.leaves:
        jleaf = js.column(leaf.path)
        assert tasm.logical_kind(leaf) == jasm.logical_kind(jleaf), leaf.path
        for v in storage_values(rng, leaf.name):
            got = outcome(lambda: norm(tasm.convert_logical(leaf, v)))
            assert got == outcome(lambda: norm(jasm.convert_logical(jleaf, v))), (leaf.path, v)
            checked += got[0] == "ok"
        if leaf.type == T.INT96:  # the (12,) row a decoded INT96 chunk yields
            row = np.frombuffer(storage_values(rng, "t96")[0], dtype=np.uint8)
            assert tasm.convert_logical(leaf, row) == jasm.convert_logical(jleaf, row)
    assert checked > 300


def test_convert_to_storage_matches_jax():
    ts, js = parse_schema(LOGICAL_DSL), j_parse_schema(LOGICAL_DSL)
    utc = dt.timezone.utc
    cases = {
        "d32": [decimal.Decimal("12.34"), decimal.Decimal("-0.01"), 7],
        "d64": [decimal.Decimal("123456.7891")],
        "dfl": [decimal.Decimal("-123456789.123"), decimal.Decimal("0")],
        "dba": [decimal.Decimal("1234567890123456789.12345"), decimal.Decimal("-1")],
        "day": [dt.date(1969, 12, 31), dt.date(2024, 2, 29)],
        "tms": [dt.time(23, 59, 59, 999_000), Time(1, 2, 3, 4_000_000)],
        "tus": [dt.time(0, 0, 0, 1), dt.time(12, 30)],
        "tns": [Time(23, 59, 59, 999_999_999), dt.time(1, 1, 1, 1)],
        "tsms": [dt.datetime(2024, 1, 1, 12, 0, 0, 123_000, tzinfo=utc),
                 dt.datetime(1700, 1, 1, tzinfo=utc)],
        "tsus": [dt.datetime(2024, 1, 1, 12, 0, 0, 123_456), dt.datetime(2300, 6, 1, 0, 0, 0, 1)],
        "tsns": [dt.datetime(2024, 1, 1, tzinfo=utc), np.datetime64(1_700_000_000_123_456_789, "ns")],
        "u32": [2**32 - 1, 2**31, 5],
        "u64": [2**64 - 1, 2**63, np.uint64(2**63 + 5)],
        "plain": [-(2**63), 3.5, None],
    }
    for name, values in cases.items():
        leaf, jleaf = ts.column((name,)), js.column((name,))
        for v in values:
            jv = JTime.from_nanos(v.nanos, utc=v.utc) if isinstance(v, Time) else v
            assert tasm.convert_to_storage(leaf, v) == jasm.convert_to_storage(jleaf, jv), (name, v)
    for name, v in (("d32", decimal.Decimal("0.001")), ("dfl", decimal.Decimal(10) ** 20)):
        with pytest.raises(ValueError) as te:
            tasm.convert_to_storage(ts.column((name,)), v)
        with pytest.raises(ValueError) as je:
            jasm.convert_to_storage(js.column((name,)), v)
        assert str(te.value) == str(je.value)


def test_logical_rows_round_trip_through_both_packages():
    rng = np.random.default_rng(9)
    rows = [{leaf.name: v for leaf, v in zip(parse_schema(LOGICAL_DSL).leaves, vals)}
            for vals in zip(*(storage_values(rng, leaf.name)[:3]
                              for leaf in parse_schema(LOGICAL_DSL).leaves))]
    sink = JMemorySink()
    w = JWriter(sink, j_parse_schema(LOGICAL_DSL))
    w.write_rows(rows)
    w.close()
    data = sink.getvalue()
    assert port_rows(data) == jax_rows(data)
    assert port_rows(data, raw=True) == jax_rows(data, raw=True)


# -- the level primitives -------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_level_primitives_match_jax(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 400))
    rep = rng.integers(0, 3, n).astype(np.uint16)
    rep[0] = 0
    dfl = rng.integers(0, 4, n).astype(np.uint16)
    for null_def in (0, 1, 3, 4):
        a, b = tlevels.validity_from_def(dfl, null_def), jlevels.validity_from_def(dfl, null_def)
        assert (a is None and b is None) or (a.dtype == b.dtype and np.array_equal(a, b))


def test_row_modules_load_no_jax_and_no_jax_package():
    code = (
        "import sys, parquet_tpu_torch, parquet_tpu_torch.core.assembly_vec, "
        "parquet_tpu_torch.core.shred, parquet_tpu_torch.core.column_store, "
        "parquet_tpu_torch.core.chunk, parquet_tpu_torch.utils.int96, "
        "parquet_tpu_torch.floor.api, parquet_tpu_torch.floor.autoschema, "
        "parquet_tpu_torch.floor.interfaces\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))"
        " or m == 'parquet_tpu' or m.startswith('parquet_tpu.'))\n"
        "print(bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, check=True
    )
    assert out.stdout.strip() == "[]"
