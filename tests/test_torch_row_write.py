"""The port's row writer against the JAX package's, byte for byte.

Both packages' FileWriter.write_row / write_rows take the same seeded rows
(a flat schema of every physical type with logical annotations: DECIMAL,
DATE, TIME, TIMESTAMP, unsigned, STRING, FLBA; and a nested one of LISTs,
a MAP, structs and a repeated group) and every file must be identical:
over codec x data page V1/V2 x dictionary on/off x write_row / write_rows,
with the auto-flush at `row_group_size` (and the size properties along
the way), with bloom_filters=, write_page_index= and parallel= (True and a
dedicated pool), with PQT_FUSED_ENCODE at 0 and 1. The refusals match the
reference's: a bad row raises the same ShredError and leaves the writer
consistent (the good rows give the JAX file of those rows alone), mixing rows and columns
gives the same WriterError, a value that does not fit its column the same
StoreError at flush. Each test runs with PQT_VEC_ASSEMBLY / PQT_VEC_FILTER
at 1 and 0, and rows read back through both packages compare exactly.
"""

import datetime as dt
import decimal

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import parquet_tpu.kernels.device_ops  # noqa: E402,F401  (turns x64 on first)
from parquet_tpu.core.writer import FileWriter as JWriter  # noqa: E402
from parquet_tpu.schema.dsl import parse_schema as j_parse_schema  # noqa: E402
from parquet_tpu.sink import MemorySink as JMemorySink  # noqa: E402
from tests.test_torch_rows import engine, jax_rows, port_rows  # noqa: E402,F401

import parquet_tpu_torch  # noqa: E402
from parquet_tpu_torch import FileWriter, WriterError, parse_schema  # noqa: E402
from parquet_tpu_torch.sink import MemorySink  # noqa: E402

UTC = dt.timezone.utc

FLAT_DSL = """message flat {
  required int64 id;
  optional int32 small;
  required double x;
  optional float f;
  required boolean flag;
  optional binary s (STRING);
  optional binary blob;
  required fixed_len_byte_array(4) code;
  optional int32 price (DECIMAL(9, 2));
  optional int64 ts (TIMESTAMP(MICROS, true));
  optional int32 day (DATE);
  optional int64 tod (TIME(MICROS, true));
  optional int64 big (INT(64, false));
}"""

NESTED_DSL = """message nested {
  required int64 id;
  optional group tags (LIST) { repeated group list { optional binary element (STRING); } }
  optional group scores (MAP) {
    repeated group key_value { required binary key (STRING); optional double value; }
  }
  optional group loc { required double lat; optional group meta { optional int32 level; } }
  repeated group hits { required int32 pos; optional binary label (STRING); }
  required group nums (LIST) { repeated group list { required int64 element; } }
  optional int64 ts (TIMESTAMP(MILLIS, true));
}"""


def flat_rows(n: int, seed: int = 1):
    rng = np.random.default_rng(seed)

    def maybe(p, v):
        return None if rng.random() < p else v

    base = dt.datetime(2024, 3, 1, tzinfo=UTC)
    return [{
        "id": int(rng.integers(0, 50)) + i * 100,
        "small": maybe(0.2, int(rng.integers(-9, 9))),
        "x": round(float(rng.standard_normal()), 3),
        "f": maybe(0.1, float(np.float32(rng.standard_normal()))),
        "flag": bool(rng.random() < 0.3),
        "s": maybe(0.05, f"s{int(rng.integers(0, 200))}"),
        "blob": maybe(0.3, bytes(int(b) for b in rng.integers(0, 256, int(rng.integers(0, 6))))),
        "code": bytes(int(b) for b in rng.integers(0, 256, 4)),
        "price": maybe(0.1, decimal.Decimal(int(rng.integers(-10**6, 10**6))) / 100),
        "ts": maybe(0.1, base + dt.timedelta(microseconds=int(rng.integers(0, 10**12)))),
        "day": maybe(0.1, dt.date(2020, 1, 1) + dt.timedelta(days=int(rng.integers(0, 2000)))),
        "tod": maybe(0.1, dt.time(int(rng.integers(0, 24)), int(rng.integers(0, 60)), 0,
                                  int(rng.integers(0, 10**6)))),
        "big": maybe(0.1, int(rng.integers(0, 2**62)) * 3),
    } for i in range(n)]


def nested_rows(n: int, seed: int = 2):
    rng = np.random.default_rng(seed)

    def maybe(p, v):
        return None if rng.random() < p else v

    return [{
        "id": i,
        "tags": maybe(0.1, [maybe(0.2, f"t{int(rng.integers(0, 30))}")
                            for _ in range(int(rng.integers(0, 4)))]),
        "scores": maybe(0.2, {f"k{int(j)}": maybe(0.2, float(j) / 2)
                              for j in rng.integers(0, 6, int(rng.integers(0, 3)))}),
        "loc": maybe(0.2, {"lat": float(rng.standard_normal()),
                           "meta": maybe(0.3, {"level": maybe(0.3, int(rng.integers(0, 5)))})}),
        "hits": [{"pos": int(rng.integers(0, 100)), "label": maybe(0.5, "h")}
                 for _ in range(int(rng.integers(0, 3)))],
        "nums": [int(v) for v in rng.integers(0, 10**6, int(rng.integers(0, 4)))],
        "ts": maybe(0.1, dt.datetime(2023, 1, 1, tzinfo=UTC)
                    + dt.timedelta(milliseconds=int(rng.integers(0, 10**10)))),
    } for i in range(n)]


SCHEMAS = {"flat": (FLAT_DSL, flat_rows), "nested": (NESTED_DSL, nested_rows)}
N = 1800


def write(W, sink, dsl_parse, dsl, rows, api, **opts):
    w = W(sink, dsl_parse(dsl), **opts)
    if api == "rows":
        w.write_rows(rows)
    else:
        for row in rows:
            w.write_row(row)
    w.close()
    return sink.getvalue()


def both(schema, api, **opts):
    dsl, make = SCHEMAS[schema]
    rows = make(N)
    want = write(JWriter, JMemorySink(), j_parse_schema, dsl, rows, api, **opts)
    parquet_tpu_torch.reset_write_counts()
    got = write(FileWriter, MemorySink(), parse_schema, dsl, rows, api, **opts)
    return want, got, parquet_tpu_torch.write_counts()


@pytest.mark.parametrize("api", ["row", "rows"])
@pytest.mark.parametrize("use_dict", [True, False], ids=["dict", "plain"])
@pytest.mark.parametrize("dpv", [1, 2], ids=["v1", "v2"])
@pytest.mark.parametrize("codec", ["uncompressed", "snappy", "gzip"])
@pytest.mark.parametrize("schema", list(SCHEMAS))
def test_row_files_match_jax(schema, codec, dpv, use_dict, api):
    want, got, counts = both(schema, api, codec=codec, data_page_version=dpv,
                             use_dictionary=use_dict, max_page_size=4096)
    assert got == want
    # the rows take the port's chunk encode: the fused walk on flat chunks
    assert counts["encode_fused_engaged"] > 0
    assert counts["encode_fallback_recovered"] == 0


def test_rows_read_back_equal_in_both_packages():
    for schema in SCHEMAS:
        _want, data, _ = both(schema, "rows", codec="snappy")
        assert port_rows(data) == jax_rows(data)
        assert port_rows(data, raw=True) == jax_rows(data, raw=True)


OPTION_SETS = {
    "blooms": {"bloom_filters": True},
    "bloom_list_index": {"bloom_filters": ["id", "s"], "write_page_index": True},
    "index": {"write_page_index": True},
    "parallel": {"parallel": True},
    "parallel2_blooms_index": {"parallel": 2, "bloom_filters": True, "write_page_index": True,
                               "max_inflight_bytes": 1},
}


@pytest.mark.parametrize("fused", ["0", "1"])
@pytest.mark.parametrize("label", list(OPTION_SETS))
def test_row_writer_options_match_jax(monkeypatch, label, fused):
    monkeypatch.setenv("PQT_FUSED_ENCODE", fused)
    opts = dict(OPTION_SETS[label])
    for schema in SCHEMAS:
        if schema == "nested" and opts.get("bloom_filters") not in (None, True):
            opts["bloom_filters"] = ["id"]
        want, got, counts = both(schema, "rows", codec="gzip", row_group_size=30_000, **opts)
        assert got == want, (schema, label)
        if fused == "0":
            assert counts["encode_fused_engaged"] == counts["encode_fused_declined"] == 0
        elif opts.get("write_page_index"):
            assert counts["encode_fused_engaged"] == 0 and counts["encode_fused_declined"] > 0


def test_auto_flush_and_sizes_match_jax():
    rows = flat_rows(5000, seed=4)
    schema, jschema = parse_schema(FLAT_DSL), j_parse_schema(FLAT_DSL)
    w = FileWriter(MemorySink(), schema, row_group_size=20_000)
    jw = JWriter(JMemorySink(), jschema, row_group_size=20_000)
    seen = []
    for k, row in enumerate(rows):
        w.write_row(row)
        jw.write_row(row)
        if k % 250 == 0:
            got = (w.current_row_group_rows, w.current_row_group_size,
                   w.estimated_buffered_size(), w.current_file_size)
            assert got == (jw.current_row_group_rows, jw.current_row_group_size,
                           jw.estimated_buffered_size(), jw.current_file_size), k
            seen.append(got[3])
    meta, jmeta = w.close(), jw.close()
    assert len(meta.row_groups) == len(jmeta.row_groups) > 2
    assert [g.num_rows for g in meta.row_groups] == [g.num_rows for g in jmeta.row_groups]
    assert w._sink.getvalue() == jw._sink.getvalue()
    assert seen[-1] > seen[0]  # groups flushed on their own along the way
    # write_rows' batched shred flushes at the same rows
    w2 = FileWriter(MemorySink(), schema, row_group_size=20_000)
    jw2 = JWriter(JMemorySink(), jschema, row_group_size=20_000)
    w2.write_rows(rows)
    jw2.write_rows(rows)
    assert w2.close() is not None and jw2.close() is not None
    assert w2._sink.getvalue() == jw2._sink.getvalue()


# -- refusals ---------------------------------------------------------------------

BAD_ROWS = {
    "required None": {"id": None, "x": 1.0, "flag": True, "code": b"abcd"},
    "not a dict": ["id", 1],
    "wrong list": {"id": 1, "nums": 5},
    "null in repeated leaf": None,  # filled per schema below
    "group not a dict": {"id": 1, "loc": 3, "nums": []},
}


def bad_row(case, schema):
    if case == "null in repeated leaf":
        return {"id": 1, "hits": [None], "nums": []}
    return BAD_ROWS[case]


@pytest.mark.parametrize("api", ["row", "rows"])
@pytest.mark.parametrize("case", list(BAD_ROWS))
@pytest.mark.parametrize("schema", list(SCHEMAS))
def test_bad_row_leaves_the_writer_consistent_like_jax(schema, case, api):
    """A bad row raises the reference's ShredError, and the file written
    after it is the reference's file of the good rows alone, byte for byte:
    the port keeps none of a failed row's entries. (The reference keeps the
    fields of a row before the one that failed, so its own file after such
    a row is not the one compared.)"""
    dsl, make = SCHEMAS[schema]
    rows = make(300)
    bad = bad_row(case, schema)

    def feed(w, head, tail):
        if api == "rows":
            w.write_rows(head)
        else:
            for row in head:
                w.write_row(row)
        w.write_rows(tail)

    errors = []
    for W, sink, parse in ((JWriter, JMemorySink, j_parse_schema),
                           (FileWriter, MemorySink, parse_schema)):
        w = W(sink(), parse(dsl))
        head = rows[:150] + [bad] + (rows[150:200] if api == "rows" else [])
        with pytest.raises(ValueError) as info:
            feed(w, head, [])
        errors.append((type(info.value).__name__, str(info.value)))
    assert errors[0] == errors[1]
    # the buffers hold the good rows alone, size signal included (a flat
    # write_rows stages its whole batch, so none of that batch is kept)
    ref = FileWriter(MemorySink(), parse_schema(dsl))
    kept = [] if (api == "rows" and schema == "flat") else rows[:150]
    feed(ref, kept, [])
    assert (w.current_row_group_rows, w.current_row_group_size) == (
        ref.current_row_group_rows, ref.current_row_group_size)
    ref.abort()
    w.write_rows(rows[200:])
    w.close()
    got = w._sink.getvalue()
    clean = JWriter(JMemorySink(), j_parse_schema(dsl))
    feed(clean, kept, rows[200:])
    clean.close()
    want = clean._sink.getvalue()
    assert got == want
    back = port_rows(got)
    assert back == jax_rows(want) and len(back) == len(kept) + 100


def test_mixing_rows_and_columns_refused_like_jax():
    row = flat_rows(1)[0]
    for W, sink, parse in ((FileWriter, MemorySink, parse_schema),
                           (JWriter, JMemorySink, j_parse_schema)):
        w = W(sink(), parse(FLAT_DSL))
        w.write_row(row)
        with pytest.raises(ValueError, match="cannot mix write_row and write_column"):
            w.write_column("id", np.arange(3))
        w.abort()
        w = W(sink(), parse(FLAT_DSL))
        w.write_column("id", np.arange(3))
        for call in (lambda: w.write_row(row), lambda: w.write_rows([row])):
            with pytest.raises(ValueError, match="cannot mix write_row and write_column"):
                call()
        w.abort()
    w = FileWriter(MemorySink(), parse_schema(FLAT_DSL))
    w.write_row(row)
    with pytest.raises(WriterError, match="cannot mix write_row and write_column"):
        w.write_device_column("id", torch.arange(3))
    w.abort()


@pytest.mark.parametrize("value", [1.5, decimal.Decimal("0.001"), "x"])
def test_unfit_values_raise_the_same_store_error(value):
    row = dict(flat_rows(1)[0])
    key = "small" if not isinstance(value, decimal.Decimal) else "price"
    row[key] = value

    def run(W, sink, parse):
        w = W(sink, parse(FLAT_DSL))
        w.write_row(row)
        try:
            w.close()
        except Exception as e:  # noqa: BLE001  (compared across packages)
            return type(e).__name__, str(e)
        return None

    want = run(JWriter, JMemorySink(), j_parse_schema)
    assert want is not None
    assert run(FileWriter, MemorySink(), parse_schema) == want
