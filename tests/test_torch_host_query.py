"""The port's host query engine against the JAX package and pyarrow, on the CPU.

The reference answers a query unit its device declines (group_by, float,
decimal, bool, string and temporal aggregates) on its pyarrow engine
(unit_partial over to_arrow); the port answers it on its host engine
(serve/aggregate.unit_partial over FileReader._host_unit_table). Held here
on one seeded corpus written by the JAX package, with every physical and
logical type the reference's engine takes (int8-64, uint8-64, float,
double, bool, string, binary, FLBA, decimal on INT32 / INT64 / FLBA, date,
time, timestamp ms / us / ns, INT96, a struct field, a list), nulls, NaN,
+-0, +-inf, an all-null column and an all-null unit:

  * _arrow_float_sum bit-equal to pc.sum and the grouped float sums to
    pyarrow's hash_sum, under hypothesis, over lengths that cross 16 and
    2^k and over null runs; the min / max tie rule of -0.0 and 0.0;
  * the unit table: its rows and null convention against the reference's
    to_arrow(filters=), the one-chunk structure of the reference's table,
    filter columns outside the projection, an on_error quarantine;
  * unit_partial against the reference's unit_partial unit by unit, the
    types as str() of the reference's arrow types;
  * _merge_value against the reference's, typed and untyped (the router's);
  * run_local_query, the daemon (POST /v1/query), the mesh router and
    `parquet-tool scan --aggregate` against the reference's bodies, byte
    for byte; refusals (bad_aggregates) and max_groups' 413 as the
    reference's status and code; engine counts host_fallback.

Known differences, each pinned by a test of its own: pyarrow numbers the
groups of some key types (float32, FIXED_LEN_BYTE_ARRAY with nulls) in its
hash table's order, the port in order of first occurrence; that order
decides only which of two keys equal in Python (-0.0 and 0.0) keeps its
key, and the order of groups whose keys render to the same JSON (bytes
that are not UTF-8). A DECIMAL sum through a router: the reference's
answers a 500, the port's the direct daemon's body.

Tolerance: exact everywhere (bytes of the bodies, bits of the floats).
"""

from __future__ import annotations

import contextlib
import http.client
import io
import json
import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pa = pytest.importorskip("pyarrow")
pc = pytest.importorskip("pyarrow.compute")
hypothesis = pytest.importorskip("hypothesis")
from hypothesis import HealthCheck, example, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import parquet_tpu.kernels.device_ops  # noqa: E402,F401  (x64 before any jnp array)
from parquet_tpu.core.reader import FileReader as JaxReader  # noqa: E402
from parquet_tpu.core.writer import FileWriter as JaxWriter  # noqa: E402
from parquet_tpu.schema.dsl import parse_schema  # noqa: E402
from parquet_tpu.serve import ScanServer as JaxServer  # noqa: E402
from parquet_tpu.serve import ServeConfig as JaxConfig  # noqa: E402
from parquet_tpu.serve import aggregate as jagg  # noqa: E402
from parquet_tpu.serve import mesh as jmesh  # noqa: E402
from parquet_tpu.serve.protocol import ServeError as JaxServeError  # noqa: E402
from parquet_tpu.serve.protocol import parse_query_request as jparse  # noqa: E402
from parquet_tpu.tools import parquet_tool as jtool  # noqa: E402

from parquet_tpu_torch.core.reader import FileReader  # noqa: E402
from parquet_tpu_torch.core.unit_table import HostColumn  # noqa: E402
from parquet_tpu_torch.serve import ScanServer, ServeConfig  # noqa: E402
from parquet_tpu_torch.serve import aggregate as agg  # noqa: E402
from parquet_tpu_torch.serve import mesh as pmesh  # noqa: E402
from parquet_tpu_torch.serve.protocol import ServeError, parse_query_request  # noqa: E402
from parquet_tpu_torch.tools import parquet_tool as ttool  # noqa: E402

WATCHDOG_S = 30.0

DSL = """message m {
  required int64 id;
  optional int32 g;
  optional binary gs (UTF8);
  optional double gf;
  optional int32 i8 (INT(8, true));
  optional int32 i16 (INT(16, true));
  optional int32 i32;
  optional int64 i64;
  optional int32 u8 (INT(8, false));
  optional int32 u16 (INT(16, false));
  optional int32 u32 (INT(32, false));
  optional int64 u64 (INT(64, false));
  optional float f32;
  optional double f64;
  optional boolean b;
  optional binary s (UTF8);
  optional binary bin;
  optional fixed_len_byte_array(4) flba;
  optional int32 d32 (DECIMAL(9, 2));
  optional int64 d64 (DECIMAL(18, 3));
  optional fixed_len_byte_array(16) dfl (DECIMAL(38, 4));
  optional fixed_len_byte_array(5) dfl5 (DECIMAL(11, 1));
  optional int32 day (DATE);
  optional int32 tms (TIME(MILLIS, true));
  optional int64 tus (TIME(MICROS, false));
  optional int64 tns (TIME(NANOS, false));
  optional int64 tsms (TIMESTAMP(MILLIS, true));
  optional int64 tsus (TIMESTAMP(MICROS, false));
  optional int64 tsns (TIMESTAMP(NANOS, false));
  optional int96 t96;
  optional int64 nul;
  optional group st {
    optional int32 a;
    required double x;
  }
  optional group tags (LIST) {
    repeated group list {
      optional int32 element;
    }
  }
}"""

FLAT = ("g gs gf i8 i16 i32 i64 u8 u16 u32 u64 f32 f64 b s bin flba d32 d64 dfl dfl5 day "
        "tms tus tns tsms tsus tsns t96 nul").split()
# row groups a file: a one-row group and a group of 17 cross the edges of
# Arrow's 16-value blocks; the all-null group has every optional column null
GROUPS = ((300, 0.85), (17, 0.85), (1, 0.85), (1500, 0.85), (40, 0.0))
FIXED_WIDTH = ("flba", "dfl", "dfl5", "t96")


def _values(name, k, rng):
    """k dense values of column `name`."""
    if name == "g":
        return rng.integers(0, 4, k).astype(np.int32)
    if name == "gs":
        return [["a", "b", "é", ""][i] for i in rng.integers(0, 4, k)]
    if name == "gf":
        return rng.choice(np.array([0.0, -0.0, np.nan, 1.5, -np.inf]), k)
    if name in ("i8", "i16", "i32"):
        b = {"i8": 7, "i16": 15, "i32": 31}[name]
        return rng.integers(-(2**b), 2**b, k).astype(np.int32)
    if name == "i64":
        return rng.integers(-(2**63), 2**63 - 1, k, dtype=np.int64, endpoint=True)
    if name in ("u8", "u16"):
        return rng.integers(0, 2 ** {"u8": 8, "u16": 16}[name], k).astype(np.int32)
    if name == "u32":
        return rng.integers(0, 2**32, k, dtype=np.uint64).astype(np.uint32).view(np.int32)
    if name == "u64":
        return rng.integers(0, 2**64 - 1, k, dtype=np.uint64, endpoint=True).view(np.int64)
    if name in ("f32", "f64"):
        v = rng.standard_normal(k) * 1e3
        sp = rng.random(k)
        v[sp < 0.02] = np.nan
        v[(sp >= 0.02) & (sp < 0.04)] = 0.0
        v[(sp >= 0.04) & (sp < 0.06)] = -0.0
        v[(sp >= 0.06) & (sp < 0.065)] = np.inf
        v[(sp >= 0.065) & (sp < 0.07)] = -np.inf
        return v.astype(np.float32 if name == "f32" else np.float64)
    if name == "b":
        return rng.random(k) < 0.5
    if name == "s":
        return ["".join(chr(c) for c in rng.integers(97, 101, int(rng.integers(0, 4))))
                + ("é" if rng.random() < 0.1 else "") for _ in range(k)]
    if name == "bin":
        return [bytes(rng.integers(0, 256, int(rng.integers(0, 3))).astype(np.uint8))
                for _ in range(k)]
    if name == "flba":
        return [bytes(rng.integers(0, 256, 4).astype(np.uint8)) for _ in range(k)]
    if name == "d32":
        return rng.integers(-(10**9) + 1, 10**9, k).astype(np.int32)
    if name == "d64":
        return rng.integers(-(10**18) + 1, 10**18, k).astype(np.int64)
    if name == "dfl":
        return [int(x).to_bytes(16, "big", signed=True)
                for x in rng.integers(-(2**62), 2**62, k).astype(object) * 10**15]
    if name == "dfl5":
        return [int(x).to_bytes(5, "big", signed=True)
                for x in rng.integers(-(10**11) + 1, 10**11, k)]
    if name == "day":
        return rng.integers(-700_000, 2_900_000, k).astype(np.int32)
    if name == "tms":
        return rng.integers(0, 86_400_000, k).astype(np.int32)
    if name == "tus":
        return rng.integers(0, 86_400_000_000, k).astype(np.int64)
    if name == "tns":
        return rng.integers(0, 86_400_000_000_000, k).astype(np.int64)
    if name == "tsms":
        return rng.integers(-(2**45), 2**45, k).astype(np.int64)
    if name == "tsus":
        return rng.integers(-(2**55), 2**55, k).astype(np.int64)
    if name == "tsns":
        return rng.integers(-(2**62), 2**62, k).astype(np.int64)
    if name == "t96":
        return [bytes(rng.integers(0, 256, 8).astype(np.uint8)) + int(d).to_bytes(4, "little")
                for d in rng.integers(2_400_000, 2_500_000, k)]
    if name == "nul":
        return np.zeros(k, dtype=np.int64)
    raise KeyError(name)


def write_file(path, seed):
    rng = np.random.default_rng(seed)
    with JaxWriter(str(path), parse_schema(DSL), codec="snappy", row_group_size=1 << 30) as w:
        base = 0
        for n, p_valid in GROUPS:
            w.write_column("id", np.arange(base, base + n, dtype=np.int64))
            base += n
            for c in FLAT:
                valid = rng.random(n) < (0.0 if c == "nul" else p_valid)
                if c in FIXED_WIDTH and not valid.any():
                    # an all-null FIXED_LEN_BYTE_ARRAY / INT96 chunk fails
                    # the reference's to_arrow (its own test below)
                    valid[0] = True
                w.write_column(c, _values(c, int(valid.sum()), rng),
                               def_levels=valid.astype(np.uint16))
            sv = rng.random(n) < 0.8 * p_valid
            av = sv & (rng.random(n) < 0.8)
            w.write_column("st.a", rng.integers(-5, 5, int(av.sum())).astype(np.int32),
                           def_levels=sv.astype(np.uint16) + av)
            w.write_column("st.x", rng.standard_normal(int(sv.sum())),
                           def_levels=sv.astype(np.uint16))
            rep, dfl, vals = [], [], []
            for _ in range(n):
                r = rng.random()
                if r < 0.1:
                    rep.append(0)
                    dfl.append(0)
                    continue
                k = int(rng.integers(0, 3))
                if k == 0:
                    rep.append(0)
                    dfl.append(1)
                    continue
                for j in range(k):
                    rep.append(0 if j == 0 else 1)
                    if rng.random() < 0.2:
                        dfl.append(2)
                    else:
                        dfl.append(3)
                        vals.append(int(rng.integers(0, 9)))
            w.write_column("tags.list.element", np.array(vals, np.int32),
                           def_levels=np.array(dfl, np.uint16),
                           rep_levels=np.array(rep, np.uint16))
            w.flush_row_group()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("host_query")
    for i in range(2):
        write_file(d / f"h{i}.parquet", 100 + i)
    return d


def paths(corpus):
    return sorted(str(p) for p in corpus.glob("h*.parquet"))


def _requests(corpus, body):
    raw = json.dumps({"paths": paths(corpus), **body}).encode()
    return parse_query_request(raw), jparse(raw)


def outcome(fn):
    """("ok", rendered body) or ("error", status, code) of a runner."""
    try:
        return ("ok", fn())
    except (ServeError, JaxServeError) as e:
        return ("error", e.status, e.code)


# -- float sums, min and max ---------------------------------------------------------

floats = st.one_of(
    st.floats(allow_nan=True, allow_infinity=True, width=64),
    st.sampled_from([0.0, -0.0, 1e308, -1e308, 1e-308, 0.1, -0.1]),
)


@st.composite
def float_chunks(draw):
    n = draw(st.sampled_from([0, 1, 2, 15, 16, 17, 31, 32, 33, 63, 64, 65, 127, 128, 129,
                              255, 256, 257, 1000, 4097]))
    seed = draw(st.integers(0, 2**32 - 1))
    rng = np.random.default_rng(seed)
    kind = draw(st.sampled_from(["normal", "wide", "specials", "drawn"]))
    if kind == "drawn":
        v = np.array(draw(st.lists(floats, min_size=n, max_size=n)), dtype=np.float64)
    elif kind == "wide":
        v = rng.standard_normal(n) * 10.0 ** rng.integers(-20, 20, n)
    elif kind == "specials":
        v = rng.choice(np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1.5, -2.5]), n)
    else:
        v = rng.standard_normal(n)
    nulls = draw(st.sampled_from(["none", "sparse", "runs", "dense", "all"]))
    if nulls == "none":
        valid = None
    elif nulls == "all":
        valid = np.zeros(n, dtype=bool)
    elif nulls == "runs":
        # runs of nulls and values whose lengths cross the 16-value blocks
        valid = np.repeat(rng.random(n) < 0.5, rng.integers(1, 40, n))[:n]
    else:
        valid = rng.random(n) < (0.9 if nulls == "sparse" else 0.3)
    return v, valid, draw(st.sampled_from([np.float64, np.float32]))


@settings(max_examples=300, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(float_chunks())
def test_arrow_float_sum_is_pyarrows_pairwise_sum(chunk):
    v, valid, dtype = chunk
    with np.errstate(all="ignore"):
        v = v.astype(dtype)
    arr = pa.array(v, mask=None if valid is None else ~valid)
    want = pc.sum(arr).as_py()
    dense = v if valid is None else v[valid]
    got = agg._arrow_float_sum(dense, valid)
    if want is None:
        assert got is None
    else:
        assert np.float64(got).tobytes() == np.float64(want).tobytes() or (
            math.isnan(got) and math.isnan(want)), (got, want)


@settings(max_examples=200, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(float_chunks(), st.integers(1, 7), st.integers(0, 2**32 - 1))
def test_grouped_float_sums_are_pyarrows_hash_sum(chunk, ngroups, seed):
    v, valid, dtype = chunk
    with np.errstate(all="ignore"):
        v = v.astype(dtype)
    n = len(v)
    g = np.random.default_rng(seed).integers(0, ngroups, n)
    t = pa.table({"k": pa.array(g), "v": pa.array(v, mask=None if valid is None else ~valid)})
    res = t.group_by("k").aggregate([("v", "sum"), ("v", "min"), ("v", "max")])
    keys = res.column(0).to_pylist()
    # the port's groups in first-occurrence order: int64 keys are numbered
    # so by pyarrow too
    assert keys == list(dict.fromkeys(g.tolist()))
    codes = np.array([keys.index(x) for x in g.tolist()], dtype=np.int64)
    col = HostColumn(None, v if valid is None else v[valid], valid, n)
    tag = "float" if dtype == np.float32 else "double"
    for j, op in enumerate(("sum", "min", "max")):
        got = agg._grouped_agg(op, col, tag, codes, len(keys))
        want = res.column(1 + j).to_pylist()
        assert [repr(x) for x in got] == [repr(x) for x in want], op


@settings(max_examples=300, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(st.integers(1, 300), st.integers(0, 2**32 - 1), st.sampled_from(["min", "max"]),
       st.sampled_from([np.float32, np.float64]), st.booleans())
@example(n=4, seed=30783, op="min", dtype=np.float32, nulls=True)  # a mask with no null
def test_global_min_max_zero_ties_are_pyarrows(n, seed, op, dtype, nulls):
    """NaN skipped unless every value is NaN; a tie of -0.0 and 0.0 as
    pyarrow's kernels break it (aggregate._ZERO_TIES)."""
    rng = np.random.default_rng(seed)
    choices = np.array([0.0, -0.0, np.nan, 1.0, -1.0, np.inf, -np.inf])
    v = rng.choice(choices, n, p=rng.dirichlet(np.ones(len(choices)) * 0.5)).astype(dtype)
    valid = rng.random(n) < rng.uniform(0.5, 1.0) if nulls else None
    arr = pa.array(v, mask=None if valid is None else ~valid)
    want = getattr(pc, op)(arr).as_py()
    tag = "float" if dtype == np.float32 else "double"
    got = agg._global_extreme(v if valid is None else v[valid], valid, op, tag)
    assert repr(got) == repr(want)


# -- the unit table -------------------------------------------------------------------

TABLE_CASES = [
    (["f64", "s"], None),
    (["f64", "st.a", "tags"], [["i32", ">", 0]]),
    (["gs"], [["gf", "==", 0.0]]),
    (["u64", "b"], [["s", "not_in", ["a", "b"]]]),
    (["d32"], [["b", "==", True]]),
    (["i8"], [[["g", "is_null"]], [["u8", "<", 10]]]),
    (["dfl", "t96"], [["id", ">", 10**9]]),  # prunes every group
    (["tsns"], [["i16", "==", 12345]]),  # in the statistics' range, matches no row
]


@pytest.mark.parametrize("cols,filters", TABLE_CASES, ids=lambda v: json.dumps(v))
def test_unit_table_rows_and_nulls_match_the_reference(corpus, cols, filters):
    """Row counts and null counts of each projected column equal the
    reference's to_arrow(row_groups=[i], columns=, filters=), a filter on a
    column outside the projection applied, with its null convention (a
    comparison with null drops the row, not_in keeps it); the reference's
    table of one group holds one chunk a column (its float sums split as
    one chunk's)."""
    for path in paths(corpus):
        with FileReader(path, device="cpu") as r, JaxReader(path, columns=cols) as jr:
            for i in range(r.num_row_groups):
                t = jr.to_arrow(row_groups=[i], filters=filters)
                ht = r._host_unit_table(i, cols, filters)
                assert ht.num_rows == t.num_rows
                for name in cols:
                    arr = t.column(name.split(".")[0])
                    assert arr.num_chunks == 1
                    if "." in name:
                        arr = pc.struct_field(arr, name.split(".")[1])
                    col = ht.column(tuple(name.split(".")))
                    assert col.null_count == arr.null_count, (path, i, name)


def test_unit_table_quarantined_group_has_no_rows(corpus, tmp_path):
    """A group dropped under on_error= is the reference's zero-row table."""
    src = paths(corpus)[0]
    raw = bytearray(open(src, "rb").read())
    with JaxReader(src) as jr:
        cc = jr.metadata.row_groups[0].columns[FLAT.index("f64") + 1].meta_data
        start = cc.dictionary_page_offset or cc.data_page_offset
    raw[start + 40: start + 60] = b"\xff" * 20  # corrupt the chunk's first page
    bad = tmp_path / "bad.parquet"
    bad.write_bytes(bytes(raw))
    with FileReader(str(bad), device="cpu", on_error="skip") as r, \
            JaxReader(str(bad), columns=["f64"], on_error="skip") as jr:
        t = jr.to_arrow(row_groups=[0], filters=[["id", ">=", 0]])
        ht = r._host_unit_table(0, ["f64"], [["id", ">=", 0]])
        assert ht.num_rows == t.num_rows == 0
        q = parse_query_request(json.dumps({"paths": [str(bad)], "aggregates": [
            "count", ["sum", "f64"], ["min", "f64"]], "filters": [["id", ">=", 0]]}).encode())
        jq = jparse(json.dumps({"paths": [str(bad)], "aggregates": [
            "count", ["sum", "f64"], ["min", "f64"]], "filters": [["id", ">=", 0]]}).encode())
        assert agg.unit_partial(ht, q) == _tagged(jagg.unit_partial(t, jq))


# -- unit partials ---------------------------------------------------------------------


def _a(op, col):
    return [op, col]


GLOBAL_COLS = [c for c in FLAT] + ["st.a", "st.x"]
UNIT_BODIES = [
    {"aggregates": ["count"] + [_a(op, c) for c in GLOBAL_COLS for op in ("count", "min", "max")
                                if (op == "count" or c != "dfl5")]},
    {"aggregates": [_a("sum", c) for c in ("g", "gf", "i8", "i16", "i32", "i64", "u8", "u16",
                                           "u32", "u64", "f32", "f64", "b", "d32", "d64",
                                           "dfl", "dfl5", "nul", "st.a", "st.x")]},
    {"aggregates": ["count", _a("count", "st"), _a("count", "tags")]},
    {"aggregates": ["count", _a("sum", "f64"), _a("min", "f32"), _a("max", "s")],
     "filters": [["i32", ">", 0]]},
    {"aggregates": ["count", _a("sum", "f32"), _a("sum", "d64"), _a("min", "tsns")],
     "filters": [["s", "not_in", ["a"]]]},
    {"aggregates": ["count", _a("sum", "i64"), _a("min", "s"), _a("max", "f64"), _a("sum", "f32"),
                    _a("sum", "d64"), _a("min", "tsns"), _a("count", "b"), _a("sum", "b"),
                    _a("max", "gf"), _a("min", "f32"), _a("max", "dfl"), _a("min", "day"),
                    _a("max", "tms"), _a("min", "tns"), _a("max", "t96"), _a("min", "bin"),
                    _a("count", "tags"), _a("max", "tsms"), _a("sum", "u64")],
     "group_by": ["g"]},
    {"aggregates": ["count", _a("sum", "f64"), _a("max", "flba")], "group_by": ["gs", "gf"]},
    {"aggregates": ["count", _a("sum", "f64"), _a("min", "u8")], "group_by": ["g", "b"],
     "filters": [["f64", ">", 0]]},
]


def _tagged(part):
    """The reference's (groups, types) with its arrow types as the port's
    tags (their str())."""
    groups, types = part
    return groups, [None if t is None else str(t) for t in types]


def _norm(x):
    """A partial for comparison: floats by repr (NaN, -0.0), the rest as
    their JSON rendering (Decimal, datetimes, pandas timestamps)."""
    if isinstance(x, dict):
        return [(tuple(_norm(k) for k in key), _norm(v)) for key, v in x.items()]
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    if isinstance(x, float):
        return repr(x)
    if x is None or isinstance(x, (bool, int, str)):
        return x
    return (type(x).__name__ in ("Timestamp", "NanoTimestamp"), str(x))


@pytest.mark.parametrize("body", UNIT_BODIES, ids=range(len(UNIT_BODIES)))
def test_unit_partials_match_the_reference(corpus, body):
    q, jq = _requests(corpus, body)
    cols = agg.query_columns(q)
    for path in paths(corpus):
        with FileReader(path, device="cpu") as r, JaxReader(path, columns=cols) as jr:
            for i in range(r.num_row_groups):
                t = jr.to_arrow(row_groups=[i], filters=jq.filters)
                want = _tagged(jagg.unit_partial(t, jq))
                got = agg.unit_partial(r._host_unit_table(i, cols, q.filters), q)
                # the groups as a set: pyarrow numbers the groups of some
                # key types in its hash table's order (the known difference
                # below), which no merge here depends on
                (groups, types), (jgroups, jtypes) = _norm(got), _norm(want)
                assert types == jtypes
                assert sorted(groups, key=repr) == sorted(jgroups, key=repr), (path, i)


# -- the merge -------------------------------------------------------------------------

MERGE_CASES = [
    ("sum", "double", 1.5, -0.0),
    ("sum", "double", -0.0, -0.0),
    ("sum", "double", float("nan"), 2.0),
    ("sum", "double", float("inf"), float("-inf")),
    ("sum", "double", 0.1, 0.2),
    ("min", "double", float("nan"), 3.0),
    ("max", "double", 3.0, float("nan")),
    ("min", "double", float("nan"), float("nan")),
    ("min", "double", -0.0, 0.0),
    ("min", "double", 0.0, -0.0),
    ("max", "double", -0.0, 0.0),
    ("max", "float", 1.5, 2.5),
    ("sum", "decimal128(38, 2)", "1.25", "-3.50"),
    ("min", "decimal128(9, 2)", "1.25", "-3.50"),
    ("max", "large_string", "b", "ab"),
    ("min", "large_string", "é", "z"),
    ("max", "large_binary", b"\x00", b""),
    ("sum", "uint64", 2**64 - 1, 2),
    ("sum", "int64", 2**62, 2**62),
    ("min", "bool", True, False),
    ("min", "date32[day]", 5, 3),
    ("max", "timestamp[us, tz=UTC]", 5, 3),
    # untyped pairs: the router's partials, parsed from replica bodies
    ("sum", None, 1.5, 2.25),
    ("sum", None, -0.0, -0.0),
    ("sum", None, 1, 2.5),
    ("min", None, 1, 2.5),
    ("max", None, 3, 2.5),
    ("min", None, float("nan"), 1.0),
    ("max", None, "2020-01-02 00:00:00", "2020-01-01 12:00:00.500000"),
    ("min", None, "-9.50", "10.25"),
    ("min", None, "é", "z"),
    ("sum", None, 2**62, 2**62),
    ("max", None, True, False),
    ("min", None, None, 4.5),
]


def _pa_value(typ, v):
    """A merge case's value as the reference holds it for `typ`."""
    import datetime
    import decimal

    if typ is None or v is None:
        return v
    if typ.startswith("decimal"):
        return decimal.Decimal(v)
    if typ == "date32[day]":
        return datetime.date(1970, 1, 1) + datetime.timedelta(days=v)
    if typ.startswith("timestamp"):
        return datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc) + \
            datetime.timedelta(microseconds=v)
    return v


def _pa_type(typ):
    if typ is None:
        return None
    if typ.startswith("decimal"):
        p, s = typ[11:-1].split(",")
        return pa.decimal128(int(p), int(s))
    return {"double": pa.float64(), "float": pa.float32(), "large_string": pa.large_string(),
            "large_binary": pa.large_binary(), "uint64": pa.uint64(), "int64": pa.int64(),
            "bool": pa.bool_(), "date32[day]": pa.date32(),
            "timestamp[us, tz=UTC]": pa.timestamp("us", tz="UTC")}[typ]


@pytest.mark.parametrize("op,typ,a,b", MERGE_CASES, ids=[str(c) for c in MERGE_CASES])
def test_merge_value_matches_the_reference(op, typ, a, b):
    a, b = _pa_value(typ, a), _pa_value(typ, b)
    for x, y in ((a, b), (b, a)):
        want = jagg._merge_value(op, x, y, _pa_type(typ))
        got = agg._merge_value(op, x, y, typ)
        assert type(got) is type(want), (x, y, got, want)
        # floats by repr (NaN, -0.0); the rest as the body renders them
        assert (repr(got) if isinstance(got, float) else str(got)) == (
            repr(want) if isinstance(want, float) else str(want)), (x, y, got, want)


def test_untyped_decimal_sums_are_the_routers_repair():
    """Two DECIMAL sums through a router are strings: the reference has no
    string sum kernel (its router answers a 500); the port sums them as
    decimals, exactly, as one daemon does."""
    import decimal

    with pytest.raises(pa.ArrowNotImplementedError):
        jagg._merge_value("sum", "1.25", "-3.50", None)
    got = agg._merge_value("sum", "1.25", "-3.50", None)
    assert got == decimal.Decimal("-2.25") and str(got) == "-2.25"
    big = "9" * 37 + ".5"
    assert str(agg._merge_value("sum", big, big, None)) == str(
        jagg._merge_value("sum", decimal.Decimal(big), decimal.Decimal(big),
                          pa.decimal128(38, 1)))


# -- bodies -------------------------------------------------------------------------------

BODIES = UNIT_BODIES[3:] + [
    {"aggregates": [_a(op, c)]} for c in ("f64", "f32", "b", "d32", "dfl", "s", "bin", "flba",
                                           "day", "tsns", "t96", "tns", "nul") for op in
    ("sum", "min", "max")
] + [
    {"aggregates": ["count", _a("sum", "i64"), _a("max", "d64")], "group_by": [k]}
    for k in ("gs", "gf", "b", "d32", "dfl", "day", "tsns", "tns", "t96", "bin", "u64", "nul",
              "tsms", "i8", "tms", "tus", "tsus", "u8")
] + [
    {"aggregates": ["count"], "group_by": ["i64"], "max_groups": 100},
    {"aggregates": ["count", _a("sum", "gf")], "group_by": ["g"], "max_groups": 4},
    {"aggregates": ["count", _a("sum", "gf")], "group_by": ["g"], "max_groups": 5},
    {"aggregates": [_a("sum", "f64"), _a("min", "gs")], "group_by": ["g"],
     "filters": [["id", ">", 10**9]]},
    {"aggregates": ["count", _a("min", "i32")], "filters": [["nul", "not_null"]]},
    {"aggregates": [_a("sum", "s")]},
    {"aggregates": [_a("sum", "tsns")]},
    {"aggregates": [_a("min", "st")]},
    {"aggregates": [_a("max", "tags")]},
    {"aggregates": ["count"], "group_by": ["st"]},
    {"aggregates": ["count"], "group_by": ["tags"]},
    {"aggregates": ["count", _a("sum", "st.a")], "group_by": ["g"]},
    {"aggregates": ["count"], "group_by": ["st.a"]},
    {"aggregates": [_a("sum", "gs")], "group_by": ["g"]},
    {"aggregates": [_a("max", "st")], "group_by": ["g"]},
]


@pytest.mark.parametrize("body", BODIES, ids=range(len(BODIES)))
def test_run_local_query_matches_the_reference(corpus, body):
    q, jq = _requests(corpus, body)
    agg.reset_query_device_counts()
    got = outcome(lambda: agg.render_query_body(agg.run_local_query(q.paths, q, device="cpu")))
    want = outcome(lambda: jagg.render_query_body(jagg.run_local_query(jq.paths, jq)))
    assert got == want
    counts = agg.query_device_counts()
    assert set(counts) <= {"device", "host_fallback"}
    if got[0] == "ok":
        # every unit that decoded ran on one engine of the ladder
        assert sum(counts.values()) == json.loads(got[1])["units"]
        if "group_by" in body:
            assert not counts.get("device")


def test_in_envelope_and_fallback_units_mix_in_one_body(corpus):
    """An integer-only query runs every unit on the device; adding a float
    sum sends them all to the host; a filter the statistics prune leaves
    no unit to run. The bodies are the reference's either way."""
    for body, engine in (
        ({"aggregates": ["count", _a("sum", "i32"), _a("max", "u64")]}, "device"),
        ({"aggregates": ["count", _a("sum", "i32"), _a("sum", "f64")]}, "host_fallback"),
    ):
        q, jq = _requests(corpus, body)
        agg.reset_query_device_counts()
        got = agg.run_local_query(q.paths, q, device="cpu")
        assert agg.render_query_body(got) == jagg.render_query_body(
            jagg.run_local_query(jq.paths, jq))
        assert agg.query_device_counts() == {engine: got["units"]}


def test_one_request_mixes_device_and_host_units(tmp_path):
    """Files whose `v` is DOUBLE in one and INT64 in the other: the device
    declines the double file's units and answers the int64 file's, and
    the one body merges both as the reference's host engine does (in the
    first unit's type, double)."""
    rng = np.random.default_rng(5)
    for name, dsl, values in (
        ("a.parquet", "message m { required double v; required int32 k; }",
         rng.standard_normal(300) * 100),
        ("b.parquet", "message m { required int64 v; required int32 k; }",
         rng.integers(-1000, 1000, 400)),
    ):
        with JaxWriter(str(tmp_path / name), parse_schema(dsl), row_group_size=1 << 30) as w:
            for part in np.array_split(values, 2):
                w.write_column("v", part)
                w.write_column("k", rng.integers(0, 3, len(part)).astype(np.int32))
                w.flush_row_group()
    files = [str(tmp_path / "a.parquet"), str(tmp_path / "b.parquet")]
    raw = json.dumps({"paths": files, "aggregates": ["count", ["sum", "v"], ["max", "v"],
                                                      ["min", "v"]]}).encode()
    q, jq = parse_query_request(raw), jparse(raw)
    agg.reset_query_device_counts()
    got = agg.render_query_body(agg.run_local_query(q.paths, q, device="cpu"))
    assert got == jagg.render_query_body(jagg.run_local_query(jq.paths, jq))
    assert agg.query_device_counts() == {"host_fallback": 2, "device": 2}


def test_known_difference_float32_zero_keys(corpus):
    """pyarrow numbers float32 key groups in its hash table's order, the
    port in order of first occurrence. A unit holding both -0.0 and 0.0
    keys: the reference's partial (a Python dict) keeps the first group's
    key with the second group's aggregates, so which comes first decides
    the body; the groups' other keys and values agree."""
    body = {"aggregates": ["count", _a("sum", "i64")], "group_by": ["f32"]}
    q, jq = _requests(corpus, body)
    got = agg.run_local_query(q.paths, q, device="cpu")
    want = jagg.run_local_query(jq.paths, jq)

    def nonzero(doc):
        return [json.dumps(g, default=agg.json_default) for g in doc["groups"]
                if g["key"][0] != 0]

    assert nonzero(got) == nonzero(want)
    assert got["group_count"] == want["group_count"]
    # the port: one zero group a unit, keyed and valued as its Python dict
    # merge of the first-occurrence groups leaves it
    zero = [g for g in got["groups"] if g["key"][0] == 0]
    assert len(zero) == 1


def test_known_difference_binary_keys_that_render_alike(corpus):
    """FIXED_LEN_BYTE_ARRAY keys that are not UTF-8 render alike in JSON;
    groups that sort as equals keep their insertion order, which follows
    pyarrow's hash table in the reference and first occurrence in the
    port. The bodies hold the same groups."""
    body = {"aggregates": ["count", _a("sum", "i64"), _a("min", "s")], "group_by": ["flba"]}
    q, jq = _requests(corpus, body)
    got = agg.run_local_query(q.paths, q, device="cpu")
    want = jagg.run_local_query(jq.paths, jq)
    canon = lambda doc: sorted(  # noqa: E731
        json.dumps(g, sort_keys=True, default=agg.json_default) for g in doc["groups"])
    assert canon(got) == canon(want)
    assert {k: v for k, v in got.items() if k != "groups"} == {
        k: v for k, v in want.items() if k != "groups"}


# -- daemon, router and tool -----------------------------------------------------------------


def request(server, method, path, body=None, headers=None):
    if isinstance(body, dict):
        body = json.dumps(body).encode()
    conn = http.client.HTTPConnection(server.host, server.port, timeout=WATCHDOG_S)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _status_code(status, raw):
    return (status, json.loads(raw)["error"]["code"]) if status != 200 else (status, raw)


@pytest.fixture(scope="module")
def fleets(corpus):
    """{"port": (direct, router), "jax": (direct, router)}: a direct daemon
    and a router over two replicas of each package, over the corpus."""
    made = []
    try:
        out = {}
        for pkg in ("jax", "port"):
            if pkg == "port":
                daemon = lambda: ScanServer(ServeConfig(port=0, root=str(corpus), device="cpu"))  # noqa: E731
                mesh = pmesh
            else:
                daemon = lambda: JaxServer(JaxConfig(port=0, root=str(corpus)))  # noqa: E731
                mesh = jmesh
            direct = daemon().start_background()
            made.append(direct)
            replicas = [daemon().start_background() for _ in range(2)]
            made.extend(replicas)
            router = mesh.MeshRouter(mesh.MeshConfig(
                port=0, replicas=tuple(r.url for r in replicas))).start_background()
            made.append(router)
            out[pkg] = (direct, router)
        yield out
    finally:
        for s in made:
            try:
                s.close()
            except Exception:  # noqa: BLE001 - close every one
                pass


HTTP_BODIES = [
    {"aggregates": ["count", _a("sum", "f64"), _a("min", "f32"), _a("max", "s"), _a("sum", "b")],
     "group_by": ["g"]},
    {"aggregates": ["count", _a("sum", "f64"), _a("sum", "f32"), _a("min", "gs")]},
    {"aggregates": ["count", _a("sum", "i64"), _a("max", "gf")], "group_by": ["gs", "b"],
     "filters": [["i32", ">", 0]]},
    {"aggregates": [_a("min", "tsns"), _a("max", "day"), _a("min", "t96")], "group_by": ["g"]},
    {"aggregates": ["count", _a("min", "f64")], "group_by": ["gf"]},
    {"aggregates": [_a("sum", "s")]},
    {"aggregates": [_a("min", "tags")]},
    {"aggregates": ["count"], "group_by": ["st"]},
    {"aggregates": ["count"], "group_by": ["i64"], "max_groups": 50},
    {"aggregates": ["count", _a("sum", "d32"), _a("sum", "dfl")], "group_by": ["g"]},
    {"aggregates": [_a("min", "d64"), _a("max", "dfl")]},
]
# a dotted name through a list: the reference's raw pyarrow error, a 500 on
# the daemons (not routed: a replica's 500 counts against its health)
DAEMON_BODIES = HTTP_BODIES + [{"aggregates": [_a("count", "tags.list.element")]}]


def _http(server, body, corpus):
    return request(server, "POST", "/v1/query", {"paths": "h*.parquet", **body})


@pytest.mark.parametrize("body", DAEMON_BODIES, ids=range(len(DAEMON_BODIES)))
def test_daemon_bodies_match_the_reference(fleets, corpus, body):
    """POST /v1/query on the port's daemon: the reference daemon's status
    and body (errors: status and code), and the port's run_local_query."""
    agg.reset_query_device_counts()
    got = _http(fleets["port"][0], body, corpus)
    want = _http(fleets["jax"][0], body, corpus)
    assert _status_code(*got) == _status_code(*want)
    if got[0] == 200:
        q = parse_query_request(json.dumps({"paths": paths(corpus), **body}).encode())
        local = agg.render_query_body(agg.run_local_query(q.paths, q, device="cpu"))
        assert got[1] == local
        assert agg.query_device_counts()["host_fallback"] >= json.loads(got[1])["units"]


@pytest.mark.parametrize("body", HTTP_BODIES, ids=range(len(HTTP_BODIES)))
def test_router_bodies_match_the_reference(fleets, corpus, body):
    """Through the mesh router: the port's router answers the reference
    router's status and body, and its direct daemon's body, except where
    the reference router answers a 500 (a DECIMAL sum: the port repairs it
    to the direct daemon's body) or answers other than its own direct
    daemon (a DECIMAL or string min / max merges the rendered strings, as
    the reference's does)."""
    port_r = _http(fleets["port"][1], body, corpus)
    port_d = _http(fleets["port"][0], body, corpus)
    jax_r = _http(fleets["jax"][1], body, corpus)
    jax_d = _http(fleets["jax"][0], body, corpus)
    decimal_sum = any(a[0] == "sum" and a[1] in ("d32", "d64", "dfl")
                      for a in body["aggregates"] if isinstance(a, list))
    if decimal_sum:
        assert jax_r[0] == 500
        assert port_r == port_d and _status_code(*port_d) == _status_code(*jax_d)
        return
    assert _status_code(*port_r) == _status_code(*jax_r)
    assert _status_code(*port_d) == _status_code(*jax_d)
    if jax_r == jax_d or jax_r[0] != 200:
        assert _status_code(*port_r) == _status_code(*port_d)


def _cli(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue(), err.getvalue()


SCAN_CASES = [
    ('["count", ["sum", "f64"], ["min", "s"], ["max", "tsns"]]', ["--group-by", "g"]),
    ('["count", ["sum", "f32"], ["sum", "d64"]]', ["--group-by", "gs,b"]),
    ('[["sum", "f64"], ["max", "gf"]]', ["--filters", '[["i32", ">", 0]]']),
    ('[["sum", "s"]]', []),
    ('["count"]', ["--group-by", "i64", "--max-groups", "20"]),
]


@pytest.mark.parametrize("spec,extra", SCAN_CASES, ids=lambda v: str(v))
def test_scan_aggregate_matches_the_reference(corpus, spec, extra):
    glob = str(corpus / "h*.parquet")
    j = _cli(jtool.main, ["scan", glob, "--aggregate", spec, *extra])
    t = _cli(ttool.main, ["scan", glob, "--cpu", "--aggregate", spec, *extra])
    assert t == j


def test_nano_timestamps_render_as_pandas():
    pd = pytest.importorskip("pandas")
    for ns in (0, 1, 999, 1000, 1_000_000_000, -1, -1001, 1_600_000_000_123_456_789,
               -(2**62), 2**62):
        for utc in (False, True):
            want = str(pd.Timestamp(ns, unit="ns", tz="UTC" if utc else None))
            assert str(agg.NanoTimestamp(ns, utc)) == want


def test_all_null_fixed_width_chunk_is_a_reference_fault(tmp_path):
    """A FIXED_LEN_BYTE_ARRAY DECIMAL or INT96 chunk with no value fails
    the reference's to_arrow (its decimal and timestamp rebuilds read a
    value buffer pyarrow did not allocate: a ValueError its daemon answers
    as a 422). The port's host engine answers the nulls (ROADMAP
    section 3)."""
    path = tmp_path / "nulls.parquet"
    schema = parse_schema("""message m { required int64 id;
      optional fixed_len_byte_array(16) d (DECIMAL(38, 4)); optional int96 t; }""")
    with JaxWriter(str(path), schema) as w:
        w.write_column("id", np.arange(5, dtype=np.int64))
        for c in ("d", "t"):
            w.write_column(c, [], def_levels=np.zeros(5, dtype=np.uint16))
    body = {"paths": [str(path)], "aggregates": ["count", ["count", "d"], ["sum", "d"],
                                                  ["min", "d"], ["max", "t"]]}
    raw = json.dumps(body).encode()
    with pytest.raises(ValueError):
        jagg.run_local_query([str(path)], jparse(raw))
    q = parse_query_request(raw)
    got = agg.run_local_query(q.paths, q, device="cpu")
    assert got["result"] == {"count": 5, "count(d)": 0, "sum(d)": None, "min(d)": None,
                             "max(t)": None}


def test_profile_device_labels_a_declined_aggregate_as_the_reference(tmp_path):
    """`profile --device`: a sum over a DECIMAL column is outside the device
    envelope, and the aggregate lane reads as the reference's does."""
    import re

    path = tmp_path / "dec.parquet"
    with JaxWriter(str(path), parse_schema(
            "message m { required int32 d (DECIMAL(9, 2)); required int64 x; }")) as w:
        w.write_column("d", np.arange(50, dtype=np.int32))
        w.write_column("x", np.arange(50, dtype=np.int64))
    flt = '[[["x", ">=", 10]]]'
    t = _cli(ttool.main, ["profile", str(path), "-o", str(tmp_path / "t.json"), "--device",
                          "--cpu", "--filter", flt])
    j = _cli(jtool.main, ["profile", str(path), "-o", str(tmp_path / "j.json"), "--device",
                          "--filter", flt])
    lane = re.compile(r"aggregate lane: [^)]*\)")
    assert t[0] == j[0] == 0
    assert lane.findall(t[1]) == lane.findall(j[1]) == ["aggregate lane: host (device declined)"]
