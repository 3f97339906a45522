"""FileReader.to_arrow and write_column's Arrow ingest: the port against the
JAX package, bit for bit.

The port's to_arrow builds its own Arrow arrays (parquet_tpu_torch.core.
arrow_format) without pyarrow; each case serializes them with the port's
IPC stream writer (core/arrow_ipc.py), reads the stream with pyarrow, and
holds the table `equals` the JAX package's to_arrow on the same file
(schema, types and every value). Cases:

  * every file under tests/golden/data, on the host and device_roundtrip
    backends (the port's decode through the device path on the CPU);
  * the shapes of tests/test_arrow_logical.py (temporal types, ints,
    decimals, float16, INT96, logical types in lists, structs and maps)
    and tests/test_arrow_nested.py (structs, maps, multi-level lists,
    list-of-struct, struct-of-list, legacy repeated groups and leaves),
    each also with row_groups=[] (the zero-row table of the same schema);
  * projections, row-group subsets, filters (DNF, logical literals, in,
    projected-out and nested filter columns, null semantics; a predicate
    the host mask declines is a typed VecFilterError), read_dictionary,
    on_error quarantine;
  * a hypothesis sweep over generated nested tables, as
    tests/test_arrow_nested_fuzz.py sweeps the reference;
  * write_column of the port's arrays gives the file bytes the JAX
    package's write_column gives for the same pyarrow arrays.

Tolerance: exact throughout.
"""

from __future__ import annotations

import datetime as dt
import decimal
import io
from pathlib import Path

import numpy as np
import pytest

pa = pytest.importorskip("pyarrow")
pq = pytest.importorskip("pyarrow.parquet")
hypothesis = pytest.importorskip("hypothesis")
from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import parquet_tpu.kernels.device_ops  # noqa: E402,F401  (x64 before any jnp array)
from parquet_tpu import FileReader as JReader  # noqa: E402
from parquet_tpu import FileWriter as JWriter  # noqa: E402
from parquet_tpu import parse_schema as jparse  # noqa: E402
from parquet_tpu.sink import MemorySink as JMemorySink  # noqa: E402

from parquet_tpu_torch import FileReader, FileWriter, parse_schema  # noqa: E402
from parquet_tpu_torch.core import arrow_format as paf  # noqa: E402
from parquet_tpu_torch.core import arrow_ipc  # noqa: E402
from parquet_tpu_torch.core.filter_vec import VecFilterError  # noqa: E402
from parquet_tpu_torch.sink import MemorySink  # noqa: E402

GOLDEN = sorted((Path(__file__).parent / "golden" / "data").glob("*.parquet"))
BACKENDS = ["host", "device_roundtrip"]


def via_pyarrow(table) -> "pa.Table":
    """The port's table, written by the port's stream writer, read by
    pyarrow."""
    return pa.ipc.open_stream(arrow_ipc.serialize_table(table)).read_all()


def reference_to_arrow(path, **kw):
    """The JAX package's to_arrow. Where it raises on a flat FLBA or INT96
    column chunk with no non-null cell (ROADMAP section 3), a whole-file
    read is pyarrow's own, cast to the schema the reference gives the file
    (its zero-row table's): the reference's oracle."""
    try:
        with JReader(path) as r:
            return r.to_arrow(**kw)
    except ValueError as e:
        if kw or "buffer is smaller than requested size" not in str(e):
            raise
    with JReader(path) as r:
        schema = r.to_arrow(row_groups=[]).schema
    return pq.read_table(path).cast(schema)


def both(path, backend="host", **kw):
    """(the port's to_arrow through pyarrow, the JAX package's to_arrow)."""
    with FileReader(path, device="cpu", backend=backend) as r:
        got = via_pyarrow(r.to_arrow(**kw))
    return got, reference_to_arrow(path, **kw)


def check(path, backend="host", **kw):
    got, want = both(path, backend, **kw)
    assert got.schema.equals(want.schema), (got.schema, want.schema)
    assert got.equals(want)
    return got


# -- golden files -------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("path", GOLDEN, ids=[p.stem for p in GOLDEN])
def test_golden_files_equal_the_reference(path, backend):
    check(str(path), backend)


# -- shapes ---------------------------------------------------------------------------


def _temporal(tmp):
    n = 300
    rng = np.random.default_rng(1)
    base = dt.datetime(2020, 1, 2, 3, 4, 5, 123456)
    t = pa.table({
        "ts_us": pa.array([None if i % 11 == 0 else base + dt.timedelta(seconds=int(s))
                           for i, s in enumerate(rng.integers(0, 10**6, n))], pa.timestamp("us")),
        "ts_ms": pa.array(rng.integers(0, 10**12, n), pa.timestamp("ms")),
        "ts_ns": pa.array(rng.integers(0, 10**17, n), pa.timestamp("ns")),
        "ts_tz": pa.array(rng.integers(0, 10**15, n), pa.timestamp("us", tz="UTC")),
        "d": pa.array(rng.integers(-10**4, 10**4, n).astype(np.int32), pa.date32()),
        "t_ms": pa.array(rng.integers(0, 86_400_000, n).astype(np.int32), pa.time32("ms")),
        "t_us": pa.array(rng.integers(0, 86_400_000_000, n), pa.time64("us")),
        "t_ns": pa.array(rng.integers(0, 86_400_000_000_000, n), pa.time64("ns")),
        "i8": pa.array(rng.integers(-128, 128, n).astype(np.int8)),
        "i16": pa.array(rng.integers(-2**15, 2**15, n).astype(np.int16)),
        "u8": pa.array(rng.integers(0, 256, n).astype(np.uint8)),
        "u16": pa.array(rng.integers(0, 2**16, n).astype(np.uint16)),
        "u32": pa.array(rng.integers(0, 2**32, n).astype(np.uint32)),
        "u64": pa.array(rng.integers(0, 2**63, n).astype(np.uint64) * 2 + 1),
    })
    pq.write_table(t, tmp, coerce_timestamps=None, allow_truncated_timestamps=False)


def _decimals(tmp):
    vals = [decimal.Decimal("1.23"), None, decimal.Decimal("-45.60"), decimal.Decimal("0.01")]
    t = pa.table({
        "d9": pa.array(vals, pa.decimal128(9, 2)),
        "d18": pa.array(vals, pa.decimal128(18, 2)),
        "d38": pa.array(vals, pa.decimal128(38, 2)),
        "d5": pa.array([decimal.Decimal(v) for v in ("12345", "-1", "0", "99999")],
                       pa.decimal128(5, 0)),
    })
    pq.write_table(t, tmp)


def _int_decimals(tmp):
    schema = parse_schema(
        "message m { required int32 a (DECIMAL(9,2)); required int64 b (DECIMAL(18,4)); "
        "optional fixed_len_byte_array(5) c (DECIMAL(11,3)); }")
    with FileWriter(tmp, schema) as w:
        w.write_column("a", np.array([123, -5, 0], np.int32))
        w.write_column("b", np.array([10**17, -(10**17), 7], np.int64))
        w.write_column("c", np.array([[0, 0, 0, 1, 0], [255, 255, 255, 255, 1]], np.uint8),
                       def_levels=[1, 0, 1])


def _float16(tmp):
    t = pa.table({"h": pa.array(np.array([1.5, -2.25, 65504, 0], np.float16)),
                  "hn": pa.array(np.array([1, 2, 3, 4], np.float16),
                                 mask=np.array([0, 1, 0, 1], bool))})
    pq.write_table(t, tmp)


def _int96(tmp):
    t = pa.table({"ts": pa.array([dt.datetime(2001, 2, 3, 4, 5, 6, 789000), None,
                                  dt.datetime(1969, 12, 31, 23, 59, 59)], pa.timestamp("ns"))})
    pq.write_table(t, tmp, use_deprecated_int96_timestamps=True)


def _lists_of_logical(tmp):
    t = pa.table({
        "lt": pa.array([[dt.datetime(2020, 1, 1), None], None, []], pa.list_(pa.timestamp("ms"))),
        "ld": pa.array([[decimal.Decimal("1.5")], [None, decimal.Decimal("-2.5")], None],
                       pa.list_(pa.decimal128(6, 1))),
        "lu": pa.array([[1, 2**40], [], None], pa.list_(pa.uint64())),
        "ls": pa.array([["a", None, "bc"], None, []], pa.list_(pa.string())),
    })
    pq.write_table(t, tmp)


def _struct_logical(tmp):
    t = pa.table({"s": pa.array(
        [{"d": dt.date(2020, 5, 6), "u": 7, "t": dt.time(1, 2, 3)}, None,
         {"d": None, "u": None, "t": None}],
        pa.struct([("d", pa.date32()), ("u", pa.uint16()), ("t", pa.time64("us"))]))})
    pq.write_table(t, tmp)


def _map_logical(tmp):
    t = pa.table({"m": pa.array(
        [[("a", decimal.Decimal("1.25"))], None, [("b", None), ("c", decimal.Decimal("-3.00"))]],
        pa.map_(pa.string(), pa.decimal128(7, 2)))})
    pq.write_table(t, tmp)


def _struct_of_list(tmp):
    t = pa.table({"s": pa.array(
        [{"v": [1, 2], "w": "a"}, {"v": None, "w": None}, None, {"v": [], "w": "d"},
         {"v": [None, 5], "w": "e"}],
        pa.struct([("v", pa.list_(pa.int64())), ("w", pa.string())]))})
    pq.write_table(t, tmp)


def _list_of_struct(tmp):
    t = pa.table({"ls": pa.array(
        [[{"a": 1, "b": "x"}, {"a": None, "b": None}], [], None, [None, {"a": 4, "b": "q"}]],
        pa.list_(pa.struct([("a", pa.int64()), ("b", pa.string())])))})
    pq.write_table(t, tmp)


def _map_null_values(tmp):
    t = pa.table({"m": pa.array([[("k1", 1.5), ("k2", None)], [], None, [("k3", 3.0)]],
                                pa.map_(pa.string(), pa.float64()))})
    pq.write_table(t, tmp)


def _three_level_list(tmp):
    t = pa.table({"lll": pa.array(
        [[[[1, None], []], None, [[2]]], None, [], [[]], [[[], [3, 4, 5]]]],
        pa.list_(pa.list_(pa.list_(pa.int32()))))})
    pq.write_table(t, tmp)


def _map_of_lists(tmp):
    t = pa.table({"ml": pa.array([[("a", [1, 2]), ("b", None)], None, [("c", [])]],
                                 pa.map_(pa.string(), pa.list_(pa.int64())))})
    pq.write_table(t, tmp)


def _struct_in_struct(tmp):
    inner = pa.struct([("x", pa.int32()), ("y", pa.string())])
    t = pa.table({"o": pa.array(
        [{"i": {"x": 1, "y": "a"}, "z": 1.0}, {"i": None, "z": None}, None,
         {"i": {"x": None, "y": None}, "z": 4.0}],
        pa.struct([("i", inner), ("z", pa.float64())]))})
    pq.write_table(t, tmp)


def _list_struct_list(tmp):
    elem = pa.struct([("tags", pa.list_(pa.string())), ("n", pa.int64())])
    t = pa.table({"deep": pa.array(
        [[{"tags": ["a", None], "n": 1}, {"tags": None, "n": None}], None, [], [None],
         [{"tags": [], "n": 9}]], pa.list_(elem))})
    pq.write_table(t, tmp)


def _all_null_struct(tmp):
    t = pa.table({"g": pa.array([None] * 40, pa.struct([("a", pa.int64()), ("b", pa.string())]))})
    pq.write_table(t, tmp)


def _fixed_in_nested(tmp):
    t = pa.table({
        "s": pa.array([{"f": b"abcd"}, None, {"f": None}], pa.struct([("f", pa.binary(4))])),
        "lf": pa.array([[b"pqrs", None], None, [b"wxyz"]], pa.list_(pa.binary(4))),
    })
    pq.write_table(t, tmp, use_dictionary=False)


def _random_multi_group(tmp):
    rng = np.random.default_rng(42)
    n = 1_200

    def maybe(p, v):
        return None if rng.random() < p else v

    rows_s = [maybe(0.1, {"v": maybe(0.2, [maybe(0.15, int(x)) for x in
                                           rng.integers(0, 99, int(rng.integers(0, 5)))]),
                          "w": maybe(0.2, f"s{int(rng.integers(0, 50))}")}) for _ in range(n)]
    rows_m = [maybe(0.1, [(f"k{j}", maybe(0.2, float(j))) for j in range(int(rng.integers(0, 4)))])
              for _ in range(n)]
    t = pa.table({
        "s": pa.array(rows_s, pa.struct([("v", pa.list_(pa.int64())), ("w", pa.string())])),
        "m": pa.array(rows_m, pa.map_(pa.string(), pa.float64())),
        "flat": pa.array(rng.integers(0, 1 << 40, n), pa.int64()),
        "opt": pa.array(rng.integers(0, 9, n).astype(np.int32), mask=rng.random(n) < 0.3),
        "str": pa.array([maybe(0.2, f"z{i % 17}") for i in range(n)]),
    })
    pq.write_table(t, tmp, row_group_size=300, compression="snappy")


def _own_writer(schema_text, rows):
    def make(tmp):
        with FileWriter(tmp, parse_schema(schema_text)) as w:
            w.write_rows(rows)
    return make


SHAPES = {
    "temporal_and_ints": _temporal,
    "decimals": _decimals,
    "int_and_flba_decimals": _int_decimals,
    "float16": _float16,
    "int96": _int96,
    "lists_of_logical": _lists_of_logical,
    "struct_with_logical_members": _struct_logical,
    "map_with_logical_values": _map_logical,
    "struct_of_list": _struct_of_list,
    "list_of_struct": _list_of_struct,
    "map_with_null_values": _map_null_values,
    "three_level_list": _three_level_list,
    "map_of_list_values": _map_of_lists,
    "struct_in_struct": _struct_in_struct,
    "list_of_struct_of_list": _list_struct_list,
    "all_null_struct": _all_null_struct,
    "fixed_width_in_nested": _fixed_in_nested,
    "randomized_multi_row_group": _random_multi_group,
    "bare_repeated_leaf": _own_writer("message m { repeated int32 r; }",
                                      [{"r": [1, 2, 3]}, {"r": []}, {"r": [7]}]),
    "bare_repeated_string_leaf": _own_writer("message m { repeated binary s (UTF8); }",
                                             [{"s": ["a", "bb"]}, {"s": []}, {"s": ["ccc"]}]),
    "legacy_repeated_group": _own_writer(
        "message m { repeated group rec { required int64 id; optional binary tag (UTF8); } }",
        [{"rec": [{"id": 1, "tag": "a"}, {"id": 2, "tag": None}]}, {"rec": []},
         {"rec": [{"id": 3, "tag": "c"}]}]),
    "optional_group_bare_repeated_leaf": _own_writer(
        "message m { required group a { optional group b { repeated int32 c; } } }",
        [{"a": {"b": {"c": [5, 6]}}}, {"a": {"b": {"c": []}}}, {"a": {"b": None}}]),
    "own_writer_list_of_struct": _own_writer(
        "message m { optional group s (LIST) { repeated group list { optional group element "
        "{ required int64 x; optional binary y (UTF8); } } } }",
        [{"s": [{"x": 1, "y": "a"}, {"x": 2, "y": None}]}, {"s": None}, {"s": []},
         {"s": [None]}]),
}


@pytest.fixture(scope="module")
def shape_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_arrow_shapes")
    out = {}
    for name, make in SHAPES.items():
        out[name] = str(d / f"{name}.parquet")
        make(out[name])
    return out


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_shapes_equal_the_reference(shape_files, name, backend):
    got = check(shape_files[name], backend)
    empty = check(shape_files[name], backend, row_groups=[])
    assert empty.num_rows == 0 and empty.schema.equals(got.schema)


def test_projections_and_row_groups(shape_files):
    p = shape_files["randomized_multi_row_group"]
    for kw in ({"columns": ["flat", "str"]}, {"row_groups": [1, 3]},
               {"columns": ["s.w", "m"], "row_groups": [0, 2]}, {"columns": ["s.v"]},
               {"columns": ["m.key_value.key"]}, {"columns": ["m.key_value.key"], "row_groups": []}):
        check(p, **kw)
    out = check(shape_files["struct_in_struct"], columns=["o.i.x", "o.z"])
    assert out.schema.field("o").type.num_fields == 2


# -- filters --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def filter_file(tmp_path_factory):
    n = 6_000
    rng = np.random.default_rng(9)
    t = pa.table({
        "id": pa.array(np.arange(n, dtype=np.int64)),
        "cat": pa.array([f"c{i % 23}" for i in range(n)]),
        "when": pa.array([dt.datetime(2024, 1, 1) + dt.timedelta(minutes=int(i)) for i in range(n)],
                         pa.timestamp("us")),
        "x": pa.array(rng.standard_normal(n)),
        "opt": pa.array(rng.integers(0, 9, n), mask=rng.random(n) < 0.2),
        "g": pa.array([{"b": i, "c": i % 7} for i in range(n)],
                      pa.struct([("b", pa.int64()), ("c", pa.int64())])),
        "fx": pa.array([bytes([i % 251, 1, 2]) for i in range(n)], pa.binary(3)),
    })
    p = str(tmp_path_factory.mktemp("torch_arrow_filters") / "f.parquet")
    pq.write_table(t, p, row_group_size=1_000, compression="snappy")
    return p


FILTERS = [
    [("id", ">=", 5_900)],
    [("cat", "==", "c7"), ("id", "<", 2_000)],
    [[("id", "<", 100)], [("id", ">=", 5_950)]],
    [("cat", "in", ["c1", "c2"]), ("id", ">", 4_000)],
    [("when", ">=", dt.datetime(2024, 1, 4))],
    [("id", "<", 0)],
    [("opt", "is_null")],
    [("opt", "not_in", [1, 2])],
    [("opt", ">", 4)],
    [("g.c", "==", 3)],
    [],
]


@pytest.mark.parametrize("flt", FILTERS, ids=range(len(FILTERS)))
def test_filters_equal_the_reference(filter_file, flt):
    check(filter_file, filters=flt)
    check(filter_file, filters=flt, columns=["id", "g.b"])
    check(filter_file, filters=flt, row_groups=[0, 5], columns=["cat"])


def test_declined_predicate_is_typed(filter_file):
    """An ordered compare on FIXED_LEN_BYTE_ARRAY: the host mask declines
    it, and where the reference evaluates it with pyarrow compute the port
    raises the typed VecFilterError."""
    flt = [("fx", ">", b"\x05\x01\x02")]
    with JReader(filter_file) as r:
        assert r.to_arrow(filters=flt).num_rows > 0
    with FileReader(filter_file, device="cpu") as r:
        with pytest.raises(VecFilterError):
            r.to_arrow(filters=flt)


def test_bad_filter_column_raises_the_references_error(filter_file):
    from parquet_tpu.core.filter import FilterError as JFilterError

    from parquet_tpu_torch.core.filter import FilterError

    with JReader(filter_file) as r, pytest.raises(JFilterError) as ej:
        r.to_arrow(filters=[("nope", "==", 1)])
    with FileReader(filter_file, device="cpu") as r, pytest.raises(FilterError) as ei:
        r.to_arrow(filters=[("nope", "==", 1)])
    assert str(ei.value) == str(ej.value)


# -- read_dictionary --------------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
def test_read_dictionary_equals_the_reference(tmp_path, backend):
    n = 6_000
    t = pa.table({
        "s": pa.array([None if i % 13 == 0 else f"key_{i % 500:04d}" for i in range(n)]),
        "b": pa.array([bytes([i % 7]) * 3 for i in range(n)]),
        "i": pa.array(np.arange(n, dtype=np.int64)),
    })
    p = str(tmp_path / "rd.parquet")
    pq.write_table(t, p, use_dictionary=["s", "b"], compression="snappy", row_group_size=2_000)
    out = check(p, backend, read_dictionary=["s", "b", "i"])
    assert pa.types.is_dictionary(out.column("s").type)
    assert out.column("i").type == pa.int64()
    empty = check(p, backend, read_dictionary=["s"], row_groups=[])
    assert pa.types.is_dictionary(empty.column("s").type)
    check(p, backend, read_dictionary=["s"], filters=[("i", ">=", 3_500)])
    # the port's own stream round trip keeps the dictionary arrays
    with FileReader(p, device="cpu", backend=backend) as r:
        mine = r.to_arrow(read_dictionary=["s"])
    back = arrow_ipc.open_stream(arrow_ipc.serialize_table(mine)).read_all()
    assert back.to_pylist() == t.to_pylist()


def test_read_dictionary_overflow_normalizes_to_plain(tmp_path):
    n = 30_000
    rng = np.random.default_rng(3)
    t = pa.table({"s": pa.array([f"u{int(x):08d}" + "p" * 40 for x in rng.integers(0, n, n)])})
    p = str(tmp_path / "ov.parquet")
    pq.write_table(t, p, use_dictionary=["s"], compression="snappy", row_group_size=10_000,
                   dictionary_pagesize_limit=64 << 10)
    out = check(p, read_dictionary=["s"])
    assert out.column("s").to_pylist() == t.column("s").to_pylist()


def test_read_dictionary_unknown_column_raises(tmp_path):
    from parquet_tpu_torch.meta.file_meta import ParquetFileError

    p = str(tmp_path / "nd.parquet")
    pq.write_table(pa.table({"i": pa.array([1, 2, 3], pa.int64())}), p)
    with FileReader(p, device="cpu") as r, pytest.raises(ParquetFileError, match="read_dictionary"):
        r.to_arrow(read_dictionary=["nope"])


# -- on_error quarantine ------------------------------------------------------------------


def _corrupt_group(src: str, dst: str, group: int, column: int) -> None:
    """A copy of `src` with one data page's payload overwritten."""
    md = pq.ParquetFile(src).metadata
    cc = md.row_group(group).column(column)
    raw = bytearray(Path(src).read_bytes())
    start = cc.data_page_offset + 24
    raw[start : start + 24] = b"\xa5" * 24
    Path(dst).write_bytes(bytes(raw))


@pytest.mark.parametrize("on_error", ["skip", "null"])
def test_on_error_quarantine_equals_the_reference(tmp_path, on_error):
    n = 3_000
    t = pa.table({"id": pa.array(np.arange(n, dtype=np.int64)),
                  "opt": pa.array(np.arange(n) % 11, mask=np.arange(n) % 5 == 0),
                  "s": pa.array([f"v{i % 31}" for i in range(n)])})
    src = str(tmp_path / "src.parquet")
    pq.write_table(t, src, row_group_size=1_000, compression="snappy")
    bad = str(tmp_path / "bad.parquet")
    _corrupt_group(src, bad, group=1, column=1)
    outs = []
    for reader in (lambda: FileReader(bad, device="cpu", on_error=on_error),
                   lambda: JReader(bad, on_error=on_error)):
        got = []
        for kw in ({}, {"columns": ["id"]}, {"columns": ["opt"]},
                   {"filters": [("id", ">=", 500)], "columns": ["id"]},
                   {"filters": [("opt", ">", 3)]}, {"row_groups": [1]}):
            with reader() as r:
                table = r.to_arrow(**kw)
            got.append(table if isinstance(table, pa.Table) else via_pyarrow(table))
        outs.append(got)
    for mine, want in zip(*outs):
        assert mine.schema.equals(want.schema) and mine.equals(want)
    assert outs[0][5].num_rows == (0 if on_error == "skip" else 1_000)


@pytest.mark.parametrize("backend", BACKENDS)
def test_fixed_width_chunks_with_no_value(tmp_path, backend):
    """An FLBA or INT96 column chunk whose every cell is null (the first
    of three row groups here), flat or inside a struct, gives pyarrow's
    nulls of the column's type."""
    n = 40
    t = pa.table({
        "dec": pa.array([None] * 16 + [decimal.Decimal(i).scaleb(-3) for i in range(n - 16)],
                        pa.decimal128(12, 3)),
        "fsb": pa.array([None] * 16 + [bytes([i] * 4) for i in range(n - 16)], pa.binary(4)),
        "ts96": pa.array([None] * 16 + [dt.datetime(2020, 1, 1) + dt.timedelta(seconds=i)
                                        for i in range(n - 16)], pa.timestamp("us")),
        "nested": pa.array([{"d": None}] * 16 + [{"d": decimal.Decimal(i)} for i in range(n - 16)],
                           pa.struct([("d", pa.decimal128(12, 3))])),
    })
    p = str(tmp_path / "no_value.parquet")
    pq.write_table(t, p, row_group_size=16, use_deprecated_int96_timestamps=True)
    got = check(p, backend)
    assert got.column("dec").to_pylist()[:17] == [None] * 16 + [decimal.Decimal("0.000")]
    # one null row beside a byte array column, as a generated table had it
    one = str(tmp_path / "one_null.parquet")
    pq.write_table(pa.table({"dec": pa.array([None], pa.decimal128(12, 3)),
                             "b": pa.array([b""])}), one, use_dictionary=False)
    assert check(one, backend).column("dec").to_pylist() == [None]


# -- generated nested tables ---------------------------------------------------------------

_LEAVES = [pa.int64(), pa.int32(), pa.float64(), pa.string(), pa.bool_(), pa.date32(),
           pa.timestamp("us"), pa.binary(), pa.decimal128(12, 3)]


def _rand_type(rng, depth):
    if depth >= 3 or rng.random() < 0.45:
        return _LEAVES[int(rng.integers(0, len(_LEAVES)))]
    k = rng.random()
    if k < 0.4:
        return pa.list_(_rand_type(rng, depth + 1))
    if k < 0.75:
        return pa.struct([(f"f{j}", _rand_type(rng, depth + 1))
                          for j in range(int(rng.integers(1, 4)))])
    return pa.map_(pa.string(), _rand_type(rng, depth + 1))


def _rand_value(rng, typ, depth=0):
    if rng.random() < (0.15 if depth else 0.1):
        return None
    if pa.types.is_list(typ):
        return [_rand_value(rng, typ.value_type, depth + 1) for _ in range(int(rng.integers(0, 4)))]
    if pa.types.is_struct(typ):
        return {f.name: _rand_value(rng, f.type, depth + 1) for f in typ}
    if pa.types.is_map(typ):
        return [(f"k{j}", _rand_value(rng, typ.item_type, depth + 1))
                for j in range(int(rng.integers(0, 3)))]
    if typ == pa.int64():
        return int(rng.integers(-(2**62), 2**62))
    if typ == pa.int32():
        return int(rng.integers(-(2**31), 2**31))
    if typ == pa.float64():
        return float(rng.standard_normal())
    if typ == pa.string():
        return f"s{int(rng.integers(0, 40))}" * int(rng.integers(0, 3))
    if typ == pa.binary():
        return bytes(rng.integers(0, 256, int(rng.integers(0, 5))).astype(np.uint8))
    if typ == pa.bool_():
        return bool(rng.random() < 0.5)
    if typ == pa.date32():
        return dt.date(1970, 1, 1) + dt.timedelta(int(rng.integers(-10000, 10000)))
    if typ == pa.timestamp("us"):
        return dt.datetime(2000, 1, 1) + dt.timedelta(seconds=int(rng.integers(0, 10**9)))
    if pa.types.is_decimal(typ):
        return decimal.Decimal(int(rng.integers(-10**9, 10**9))).scaleb(-3)
    raise AssertionError(typ)


@settings(max_examples=25, deadline=None, suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(seed=st.integers(0, 2**32 - 1), rows=st.integers(1, 200),
       group=st.sampled_from([16, 64, 1_000]), codec=st.sampled_from(["snappy", "zstd", "none"]),
       dictionary=st.booleans(), version=st.sampled_from(["1.0", "2.0"]),
       backend=st.sampled_from(BACKENDS))
def test_generated_nested_tables_equal_the_reference(tmp_path, seed, rows, group, codec,
                                                     dictionary, version, backend):
    rng = np.random.default_rng(seed)
    cols = {}
    for ci in range(int(rng.integers(1, 4))):
        typ = _rand_type(rng, 0)
        cols[f"c{ci}"] = pa.array([_rand_value(rng, typ) for _ in range(rows)], typ)
    p = str(tmp_path / f"gen{seed}.parquet")
    pq.write_table(pa.table(cols), p, row_group_size=group, compression=codec,
                   use_dictionary=dictionary, data_page_version=version)
    check(p, backend)


# -- write_column of Arrow arrays ---------------------------------------------------------------


def _port_array(arr):
    """The pyarrow array as the port's own, through a pyarrow stream."""
    buf = io.BytesIO()
    t = pa.table({"x": arr})
    with pa.ipc.new_stream(buf, t.schema) as w:
        w.write_table(t)
    return arrow_ipc.open_stream(buf.getvalue()).read_all().column("x")


INGEST = [
    ("required binary s (STRING)", pa.array(["a", "bb", "", "ccc"] * 50)),
    ("required binary s (STRING)", pa.array(["a", "bb", "a"] * 40).dictionary_encode()),
    ("required binary s", pa.array([b"\x00\x01", b"", b"z"] * 30, pa.large_binary())),
    ("required binary s (STRING)", pa.array(["p", "qq", "rrr", "s"] * 9).slice(3, 20)),
    ("required int64 x", pa.array(np.arange(500, dtype=np.int64))),
    ("required int32 x", pa.array(np.arange(300, dtype=np.int32)).slice(7, 100)),
    ("required double x", pa.array(np.linspace(-1, 1, 257))),
    ("required float x", pa.array(np.linspace(-1, 1, 33, dtype=np.float32))),
    ("required boolean b", pa.array([True, False, True] * 21)),
    ("required int32 d (DATE)", pa.array(np.arange(40, dtype=np.int32), pa.date32())),
    ("required int64 t (TIMESTAMP(MICROS,true))",
     pa.array(np.arange(40) * 10**6, pa.timestamp("us", tz="UTC"))),
    ("required int64 t (TIME(NANOS,false))", pa.array(np.arange(9) * 1000, pa.time64("ns"))),
    ("required fixed_len_byte_array(4) d (DECIMAL(9,2))",
     pa.array([decimal.Decimal("1.25"), decimal.Decimal("-3.10")] * 5, pa.decimal128(9, 2))),
    ("required int64 d (DECIMAL(18,2))",
     pa.array([decimal.Decimal("12.25"), decimal.Decimal("-3.10")] * 5, pa.decimal128(18, 2))),
    ("required int32 d (DECIMAL(9,1))",
     pa.array([decimal.Decimal("12.5"), decimal.Decimal("-3.1")] * 5, pa.decimal128(9, 1))),
    ("required fixed_len_byte_array(3) f", pa.array([b"abc", b"xyz"] * 7, pa.binary(3))),
    ("required fixed_len_byte_array(2) h (FLOAT16)",
     pa.array(np.array([1.5, -2, 0.25], np.float16))),
]


@pytest.mark.parametrize("leaf,arr", INGEST, ids=range(len(INGEST)))
def test_write_column_of_arrow_arrays_equals_the_reference(leaf, arr):
    text = f"message m {{ {leaf}; }}"
    name = leaf.split()[2]
    jsink, psink = JMemorySink(), MemorySink()
    with JWriter(jsink, schema=jparse(text)) as w:
        w.write_column(name, arr)
    with FileWriter(psink, schema=parse_schema(text)) as w:
        w.write_column(name, _port_array(arr))
    assert psink.getvalue() == jsink.getvalue()


@pytest.mark.parametrize("arr,leaf", [
    (pa.array([1, None, 3], pa.int64()), "required int64 x"),
    (pa.array([decimal.Decimal("1.255")], pa.decimal128(9, 3)),
     "required int32 d (DECIMAL(9,2))"),
    (pa.array([decimal.Decimal("99999999999")], pa.decimal128(18, 0)),
     "required int32 d (DECIMAL(9,0))"),
    (pa.array(["a"]), "required int64 x"),
], ids=["nulls", "scale", "overflow", "string_into_int"])
def test_write_column_refusals_equal_the_reference(arr, leaf):
    from parquet_tpu.core.column_store import StoreError as JStoreError

    from parquet_tpu_torch.core.column_store import StoreError

    text = f"message m {{ {leaf}; }}"
    name = leaf.split()[2]
    msgs = []
    for writer, sink, parse, err, a in (
        (JWriter, JMemorySink, jparse, JStoreError, arr),
        (FileWriter, MemorySink, parse_schema, StoreError, _port_array(arr)),
    ):
        with pytest.raises(err) as ei:
            with writer(sink(), schema=parse(text)) as w:
                w.write_column(name, a)
        msgs.append(str(ei.value).replace("pyarrow ", "").replace("arrow ", ""))
    assert msgs[0] == msgs[1]


def test_port_arrays_build_like_pyarrow():
    """The port's own constructors (from_buffers, array with a mask, the
    list / map / struct / dictionary builders) stream to the tables pyarrow
    builds from the same values."""
    off = np.array([0, 2, 2, 3], np.int64)
    vals = paf.array(np.array([1, 2, 3], np.int32))
    t = paf.table({
        "i": paf.array(np.array([5, 6, 7]), mask=np.array([False, True, False])),
        "l": paf.LargeListArray.from_arrays(paf.array(off, paf.int64(), mask=np.array(
            [False, True, False, False])), vals),
        "m": paf.MapArray.from_arrays(
            np.array([0, 1, 1, 2], np.int32),
            paf.Array.from_buffers(paf.large_string(), 2, [None, np.array([0, 1, 3]), b"abc"]),
            paf.array(np.array([1.5, 2.5]))),
        "s": paf.StructArray.from_arrays([vals, paf.array(np.array([True, False, True]))],
                                         names=["a", "b"], mask=np.array([False, False, True])),
        "d": paf.DictionaryArray.from_arrays(
            paf.array(np.array([1, 0, 1], np.int32)),
            paf.Array.from_buffers(paf.string(), 2, [None, np.array([0, 1, 2], np.int32), b"xy"])),
    })
    want = pa.table({
        "i": pa.array([5, None, 7]),
        "l": pa.array([[1, 2], None, [3]], pa.large_list(pa.int32())),
        "m": pa.array([[("a", 1.5)], [], [("bc", 2.5)]], pa.map_(pa.large_string(), pa.float64())),
        "s": pa.array([{"a": 1, "b": True}, {"a": 2, "b": False}, None],
                      pa.struct([("a", pa.int32()), ("b", pa.bool_())])),
        "d": pa.DictionaryArray.from_arrays(pa.array([1, 0, 1], pa.int32()), pa.array(["x", "y"])),
    })
    got = via_pyarrow(t)
    assert got.equals(want)
    assert t.to_pylist() == want.to_pylist()
    assert t.slice(1, 2).to_pylist() == want.slice(1, 2).to_pylist()
    assert via_pyarrow(t.slice(1, 2)).equals(want.slice(1, 2))
    assert t.filter(np.array([True, False, True])).to_pylist() == want.filter(
        pa.array([True, False, True])).to_pylist()
