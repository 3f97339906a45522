"""Query aggregation in the port against the JAX package, on the CPU.

  * masked_agg (its plain version here) against kernels/device_ops.
    masked_agg_device: every dtype and op, int64 and uint64 wrap-around,
    sub-width unsigned views, NaN and signed zeros, n = 0;
  * serve/aggregate._merge_value against the reference's pyarrow merge,
    wrap-around of int64 and uint64 included;
  * run_local_query(..., device="cpu") bodies against the reference's host
    run_local_query (pyarrow) byte for byte after render_query_body, and
    each unit's device_unit_partial against the reference's, over a corpus
    with signed INT32/INT64, UINT_8/UINT_32/UINT_64, nullable and
    dictionary columns, filtered and not;
  * the declines (DeviceQueryError) against the reference's.

Tolerance: exact everywhere. The float sums compare on values whose sums are
exact in any order (small multiples of 1/4): the kernel accumulates in
double, the reference in the input's dtype.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")

# x64 flips on at device_ops import: before any jnp array is built
import parquet_tpu.kernels.device_ops as jops  # noqa: E402
import torch  # noqa: E402

from parquet_tpu.core.reader import FileReader as JaxReader  # noqa: E402
from parquet_tpu.core.writer import FileWriter as JaxWriter  # noqa: E402
from parquet_tpu.schema.dsl import parse_schema  # noqa: E402
from parquet_tpu.serve import aggregate as jagg  # noqa: E402
from parquet_tpu.serve import query_device as jqd  # noqa: E402
from parquet_tpu.serve.protocol import parse_query_request as jparse  # noqa: E402

from parquet_tpu_torch.core.reader import FileReader  # noqa: E402
from parquet_tpu_torch.kernels import device_ops as ops  # noqa: E402
from parquet_tpu_torch.kernels.pipeline import DeviceColumn  # noqa: E402
from parquet_tpu_torch.serve import aggregate as agg  # noqa: E402
from parquet_tpu_torch.serve import query_device as qd  # noqa: E402
from parquet_tpu_torch.serve.protocol import ServeError, parse_query_request  # noqa: E402

jnp = jax.numpy
M64 = (1 << 64) - 1

# -- masked_agg ------------------------------------------------------------------


def _values(dtype, n, rng):
    if dtype == np.bool_:
        return rng.random(n) < 0.5
    if np.issubdtype(dtype, np.floating):
        v = (rng.integers(-4000, 4000, n) / 4).astype(dtype)
        if n > 8:
            v[[1, 5]] = (-0.0, 0.0)
        return v
    info = np.iinfo(dtype)
    v = rng.integers(info.min, info.max, n, dtype=dtype, endpoint=True)
    if n > 4:
        v[:4] = (info.min, info.max, -1, 0)
    return v


MASKS = ("random", "all", "none", "nomask")


def _mask(kind, n, rng):
    if kind == "random":
        return rng.random(n) < 0.6
    if kind == "all":
        return np.ones(n, dtype=bool)
    if kind == "none":
        return np.zeros(n, dtype=bool)
    return None


def _port_agg(v, m, op, **kw):
    return ops.masked_agg(
        torch.from_numpy(v), None if m is None else torch.from_numpy(m), op, **kw
    )


def _same(got, want) -> bool:
    got, want = np.asarray(got), np.asarray(want)
    if np.issubdtype(want.dtype, np.floating):
        return got.dtype == want.dtype and (
            (np.isnan(got) and np.isnan(want)) or got.tobytes() == want.tobytes()
        )
    return int(got) == int(want)


@pytest.mark.parametrize("n", [0, 1, 1000])
@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("op", ["count", "sum", "min", "max"])
@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float32, np.float64, np.bool_])
def test_masked_agg_matches_jax(dtype, op, mask, n):
    rng = np.random.default_rng(n * 7 + len(mask))
    v = _values(dtype, n, rng)
    m = _mask(mask, n, rng)
    got = _port_agg(v, m, op)
    if n == 0 and op in ("min", "max"):
        # the reference's jnp.min raises on an empty array; the port gives
        # the identity, as its masked-out rows do
        ident = ops._agg_identity(torch.from_numpy(v).dtype, op, False, "cpu")
        assert torch.equal(got, ident)
        return
    jm = np.ones(n, dtype=bool) if m is None else m
    want = jops.masked_agg_device(jnp.asarray(v), jnp.asarray(jm), op)
    if dtype == np.bool_ and op == "max" and not jm.all():
        # the reference's bool identity is bool(-inf), True, for max too, so
        # any masked-out row makes its max True (ROADMAP section 3); the
        # port's identity is False
        assert bool(want)
        want = np.bool_(v[jm].any())
    assert _same(got.numpy(), want), (got, want)
    assert got.dtype == ops._agg_out_dtype(torch.from_numpy(v).dtype, op, False)


@pytest.mark.parametrize("case", ["nan", "nan_masked", "zeros", "inf"])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_masked_agg_float_specials_match_jax(dtype, op, case):
    v = np.array({"nan": [1.5, np.nan, -2.0, 0.5],
                  "nan_masked": [1.5, np.nan, -2.0, 0.5],
                  "zeros": [0.0, -0.0, -0.0, 0.0],
                  "inf": [np.inf, -np.inf, 3.0, 1.0]}[case], dtype=dtype)
    m = np.array([True, case != "nan_masked", True, True])
    for vv in (v, v[::-1].copy()):
        mm = m if vv is v else m[::-1].copy()
        got = _port_agg(vv, mm, op)
        want = jops.masked_agg_device(jnp.asarray(vv), jnp.asarray(mm), op)
        assert _same(got.numpy(), want), (case, got, want)


@pytest.mark.parametrize("bits", [None, 8, 16])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_masked_agg_unsigned_view_matches_jax(dtype, op, bits):
    """The unsigned view (bit pattern, sub-width mask, widened to uint64) of
    the port's load against the reference's _device_numeric_view + astype(
    uint64) + masked_agg_device: patterns at and above 2^31 and 2^63, sums
    wrapping past 2^64."""
    rng = np.random.default_rng(5)
    n = 5000
    info = np.iinfo(dtype)
    v = rng.integers(info.min, info.max, n, dtype=dtype, endpoint=True)
    v[:4] = (-1, info.min, info.max, 0)
    m = rng.random(n) < 0.7
    m[:4] = True
    uv = v.view(np.uint32 if dtype == np.int32 else np.uint64)
    if bits is not None:
        uv = uv & uv.dtype.type((1 << bits) - 1)
    want = jops.masked_agg_device(jnp.asarray(uv.astype(np.uint64)), jnp.asarray(m), op)
    got = _port_agg(v, m, op, unsigned=True, bits=bits)
    assert got.dtype == torch.int64
    assert int(got) & M64 == int(want)


def test_masked_agg_int64_sum_wraps_like_jax():
    v = np.array([2**63 - 1, 2**63 - 1, 5], dtype=np.int64)
    got = _port_agg(v, None, "sum")
    want = jops.masked_agg_device(jnp.asarray(v), jnp.ones(3, dtype=bool), "sum")
    assert int(got) == int(want) == (2 * (2**63 - 1) + 5) - 2**64


def test_masked_agg_refuses_bad_input():
    v = torch.arange(4)
    with pytest.raises(ValueError, match="unsupported op"):
        ops.masked_agg(v, None, "mean")
    with pytest.raises(ValueError, match="mask entries"):
        ops.masked_agg(v, torch.ones(3, dtype=torch.bool), "sum")
    with pytest.raises(TypeError, match="no unsigned view"):
        ops.masked_agg(v.double(), None, "min", unsigned=True)
    with pytest.raises(TypeError):
        ops.masked_agg(v.to(torch.int16), None, "sum")
    assert ops.masked_agg.launches == 0  # the plain version never counts


# -- the merge -----------------------------------------------------------------

MERGE_CASES = [
    ("sum", "int64", 2**63 - 1, 1),
    ("sum", "int64", -(2**63), -1),
    ("sum", "int64", -5, 7),
    ("sum", "uint64", 2**64 - 1, 2),
    ("sum", "uint64", 2**63, 2**63),
    ("sum", "uint64", 3, None),
    ("min", "int64", -(2**63), 2**63 - 1),
    ("max", "int64", -3, None),
    ("min", "uint64", 2**64 - 1, 2**63),
    ("max", "uint64", 2**64 - 1, 2**63),
    ("max", "int64", None, None),
    ("count", None, 3, 4),
]


@pytest.mark.parametrize("op,typ,a,b", MERGE_CASES, ids=[str(c) for c in MERGE_CASES])
def test_merge_value_matches_pyarrow(op, typ, a, b):
    import pyarrow as pa

    pa_typ = None if typ is None else getattr(pa, typ)()
    want = jagg._merge_value(op, a, b, pa_typ)
    assert agg._merge_value(op, a, b, typ) == want
    assert agg._merge_value(op, b, a, typ) == jagg._merge_value(op, b, a, pa_typ)


# -- query units and bodies ----------------------------------------------------

SCHEMA = """
message m {
  required int64 id;
  required int32 i32;
  required int32 u8 (UINT_8);
  required int32 u (UINT_32);
  required int64 u64 (UINT_64);
  optional int64 maybe;
  optional int32 maybe32;
  required int32 cat;
  required double score;
  required int32 dec (DECIMAL(9, 2));
  required int64 ts (TIMESTAMP_MICROS);
  required binary name (UTF8);
  optional group tags (LIST) {
    repeated group list {
      required int32 element;
    }
  }
}
"""


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Two files of three row groups each (written by the JAX package),
    chunk statistics on, so filters prune."""
    tmp = tmp_path_factory.mktemp("torch_query")
    rng = np.random.default_rng(41)
    schema = parse_schema(SCHEMA)
    paths = []
    for f in range(2):
        p = str(tmp / f"q{f}.parquet")
        with JaxWriter(p, schema, codec="snappy", row_group_size=1 << 30) as w:
            for g in range(3):
                n = 700 + 50 * g
                base = (f * 3 + g) * 10**6
                w.write_column("id", (base + rng.integers(-(10**5), 10**5, n)).astype(np.int64))
                w.write_column("i32", rng.integers(-(2**31), 2**31, n, dtype=np.int64)
                               .astype(np.int32))
                w.write_column("u8", rng.integers(0, 256, n).astype(np.int32))
                w.write_column("u", rng.integers(0, 1 << 32, n, dtype=np.uint64)
                               .astype(np.uint32).view(np.int32))
                w.write_column("u64", rng.integers(0, 2**64 - 1, n, dtype=np.uint64,
                                                   endpoint=True).view(np.int64))
                dl = (rng.random(n) < 0.8).astype(np.uint16)
                w.write_column("maybe", rng.integers(-1000, 1000, int(dl.sum())).astype(np.int64),
                               def_levels=dl)
                dl32 = (rng.random(n) < 0.5).astype(np.uint16)
                w.write_column("maybe32", rng.integers(0, 2**31 - 1, int(dl32.sum()))
                               .astype(np.int32), def_levels=dl32)
                w.write_column("cat", (rng.integers(0, 6, n) * 1000 - 2000).astype(np.int32))
                w.write_column("score", rng.standard_normal(n))
                w.write_column("dec", rng.integers(-5000, 5000, n).astype(np.int32))
                w.write_column("ts", (1_700_000_000_000_000 + np.arange(n) * 1000)
                               .astype(np.int64))
                w.write_column("name", [["x", "y", "zz"][i % 3] for i in range(n)])
                lens = rng.integers(0, 3, n)
                rep, dfl, vals = [], [], []
                for k in lens:
                    if k == 0:
                        rep.append(0)
                        dfl.append(1)
                    for j in range(k):
                        rep.append(0 if j == 0 else 1)
                        dfl.append(2)
                        vals.append(int(rng.integers(0, 9)))
                w.write_column("tags.list.element", np.array(vals, dtype=np.int32),
                               def_levels=np.array(dfl, dtype=np.uint16),
                               rep_levels=np.array(rep, dtype=np.uint16))
                w.flush_row_group()
        paths.append(p)
    return paths


def _a(op, col):
    return {"op": op, "column": col}


BODIES = [
    {"aggregates": ["count"]},
    {"aggregates": ["count", _a("sum", "id"), _a("min", "id"), _a("max", "id")]},
    {"aggregates": [_a("sum", "i32"), _a("min", "i32"), _a("max", "i32")]},
    {"aggregates": [_a("sum", "u8"), _a("min", "u8"), _a("max", "u8")]},
    {"aggregates": [_a("sum", "u"), _a("min", "u"), _a("max", "u")]},
    {"aggregates": [_a("sum", "u64"), _a("min", "u64"), _a("max", "u64")]},
    {"aggregates": [_a("count", "maybe"), _a("sum", "maybe"), _a("min", "maybe32"),
                    _a("max", "maybe32"), _a("count", "maybe32")]},
    {"aggregates": [_a("sum", "cat"), _a("min", "cat"), _a("max", "cat"), _a("count", "name")]},
    {"aggregates": ["count", _a("sum", "id")], "filters": [["id", ">", 2_000_000]]},
    {"aggregates": [_a("min", "maybe"), _a("sum", "maybe32"), _a("count", "maybe")],
     "filters": [["name", "==", "zz"]]},
    {"aggregates": ["count", _a("sum", "u64"), _a("max", "u")],
     "filters": [["maybe", "not_in", [1, 2]]]},
    {"aggregates": ["count", _a("sum", "u8"), _a("max", "maybe32")],
     "filters": [[["cat", "==", 0]], [["u8", ">=", 200], ["maybe32", "is_null"]]]},
    {"aggregates": [_a("max", "id"), _a("sum", "maybe"), _a("count", "maybe")],
     "filters": [["id", "<", -(10**13)]]},  # every group pruned: null sum/min/max
    {"aggregates": ["count", _a("min", "u64"), _a("sum", "maybe"), _a("max", "maybe32")],
     "filters": [["cat", "==", 500]]},  # in the stats' range, matches no row
    {"aggregates": [_a("min", "i32")], "filters": [["id", ">=", 4_000_000]]},
]

DECLINES = [
    {"aggregates": ["count"], "group_by": ["name"]},
    {"aggregates": [_a("sum", "score")]},
    {"aggregates": [_a("min", "dec")]},
    {"aggregates": [_a("max", "ts")]},
    {"aggregates": [_a("count", "tags.list.element")]},
    {"aggregates": [_a("sum", "name")]},
]


def _requests(paths, body):
    raw = json.dumps({"paths": paths, **body}).encode()
    return parse_query_request(raw), jparse(raw)


@pytest.mark.parametrize("body", BODIES, ids=lambda b: json.dumps(b))
def test_query_body_matches_jax_host(corpus, body):
    """The rendered body of the port's device runner equals the reference's
    pyarrow host runner's, byte for byte."""
    q, jq = _requests(corpus, body)
    agg.reset_query_device_counts()
    body_dict = agg.run_local_query(q.paths, q, device="cpu")
    got = agg.render_query_body(body_dict)
    want = jagg.render_query_body(jagg.run_local_query(jq.paths, jq))
    assert got == want
    counts = agg.query_device_counts()
    if body == {"aggregates": ["count"]}:
        assert not counts  # the footer answers count(*)
    else:
        assert counts == ({"device": body_dict["units"]} if body_dict["units"] else {})


@pytest.mark.parametrize("body", BODIES, ids=lambda b: json.dumps(b))
def test_query_units_match_jax_device_units(corpus, body):
    """Each unit's partial equals the reference's device_unit_partial, the
    reference's arrow types mapped to the port's tags."""
    q, jq = _requests(corpus, body)
    for path in corpus:
        with FileReader(path, device="cpu") as r, JaxReader(path) as jr:
            for g in range(r.num_row_groups):
                got = qd.device_unit_partial(r, g, q, q.filters)
                (jgroups, jtypes), jn, jm = jqd.device_unit_partial(jr, g, jq, jq.filters)
                tags = [None if t is None else str(t) for t in jtypes]
                assert got == ((jgroups, tags), jn, jm)


@pytest.mark.parametrize("body", DECLINES, ids=lambda b: json.dumps(b))
def test_declines_match_jax(corpus, body):
    q, jq = _requests(corpus, body)
    with JaxReader(corpus[0]) as jr:
        with pytest.raises(jqd.DeviceQueryError):
            jqd.device_unit_partial(jr, 0, jq, jq.filters)
    with FileReader(corpus[0], device="cpu") as r:
        with pytest.raises(qd.DeviceQueryError):
            qd.device_unit_partial(r, 0, q, q.filters)
    agg.reset_query_device_counts()
    with pytest.raises(ServeError) as e:
        agg.run_local_query(q.paths, q, device="cpu")
    assert (e.value.status, e.value.code) == (400, "device_declined")
    assert agg.query_device_counts() == {"declined": 1}


def test_shard_raises_typed(corpus):
    """shard= was refused (501 shard_unsupported) until the dataset planner
    was ported; it now stripes the units as the reference does, and a shard
    index out of range raises the planner's typed ValueError on both
    sides."""
    q, jq = _requests(corpus, {"aggregates": ["count"], "shard": [0, 2]})
    assert agg.run_local_query(q.paths, q, device="cpu") == jagg.run_local_query(jq.paths, jq)
    bad, jbad = _requests(corpus, {"aggregates": ["count"], "shard": [0, 2]})
    bad = bad._replace(shard=(2, 2))
    jbad = jbad._replace(shard=(2, 2))
    with pytest.raises(ValueError):
        jagg.run_local_query(jbad.paths, jbad)
    with pytest.raises(ValueError):
        agg.run_local_query(bad.paths, bad, device="cpu")


SHARD_BODIES = [
    {"aggregates": ["count", _a("sum", "id"), _a("min", "i32"), _a("max", "i32")]},
    {"aggregates": ["count", _a("sum", "id")], "filters": [["id", ">=", 1_000_000]]},
    {"aggregates": ["count", _a("sum", "u64"), _a("max", "maybe32")],
     "filters": [[["cat", "==", 0]], [["u8", ">=", 200]]]},
]


@pytest.mark.parametrize("count", [1, 2, 3, 4])
@pytest.mark.parametrize("body", SHARD_BODIES, ids=lambda b: json.dumps(b))
def test_shards_equal_reference_and_merge_to_whole(corpus, body, count):
    """Each shard's body equals the reference's run_local_query(shard=)
    (pyarrow on the host), and the shards' units partition the plan: their
    counts add up to the unsharded query's."""
    whole, _ = _requests(corpus, body)
    want = agg.run_local_query(whole.paths, whole, device="cpu")
    units = rows = 0
    for k in range(count):
        q, jq = _requests(corpus, dict(body, shard=[k, count]))
        got = agg.run_local_query(q.paths, q, device="cpu")
        assert got == jagg.run_local_query(jq.paths, jq)
        units += got["units"]
        rows += got["rows_scanned"]
    assert (units, rows) == (want["units"], want["rows_scanned"])


def test_glob_paths_and_pruned_units(corpus, tmp_path):
    """A glob expands to the sorted files; filters prune units by
    statistics, and `units` counts only the admitted ones."""
    import os

    pattern = os.path.join(os.path.dirname(corpus[0]), "q*.parquet")
    body = {"aggregates": ["count", _a("max", "id")], "filters": [["id", ">=", 4_000_000]]}
    q, jq = _requests([pattern], body)
    got = agg.run_local_query(q.paths, q, device="cpu")
    assert got == jagg.run_local_query(jq.paths, jq)
    assert got["units"] == 2  # file 1, groups 1 and 2
    with pytest.raises(FileNotFoundError):
        agg.run_local_query([str(tmp_path / "none*.parquet")], q, device="cpu")


def test_dictionary_branch_of_dense_values_gathers():
    """A chunk delivered as indices + a numeric host dictionary expands
    through dict_gather, with jnp's clamp on out-of-range indices."""
    d = np.array([5, -7, 11], dtype=np.int64)
    dc = DeviceColumn(num_values=4, indices=torch.tensor([2, 0, 1, 9], dtype=torch.int32),
                      dictionary=d)

    class Leaf:
        path_str = "c"

    got = qd._dense_values(dc, Leaf(), torch.device("cpu"))
    want = np.asarray(jnp.asarray(d)[jnp.asarray([2, 0, 1, 9])])
    np.testing.assert_array_equal(got.numpy(), want)


def test_parse_query_request_matches_jax():
    for raw in (b'{"paths": "a", "aggregates": ["count", ["sum", "x"]], "shard": "1/3"}',
                b'{"paths": ["a"], "aggregates": [{"op": "max", "column": "x"}],'
                b' "filters": [["x", ">", 1]], "group_by": "k,j", "max_groups": 7}'):
        assert tuple(parse_query_request(raw)) == tuple(jparse(raw))
    for raw in (b"", b"[]", b'{"paths": "a"}', b'{"paths": "a", "aggregates": ["avg"]}',
                b'{"paths": "a", "aggregates": ["count"], "bogus": 1}'):
        with pytest.raises(ServeError) as e:
            parse_query_request(raw)
        from parquet_tpu.serve.protocol import ServeError as JaxServeError

        with pytest.raises(JaxServeError) as je:
            jparse(raw)
        assert (e.value.status, e.value.code, e.value.message) == (
            je.value.status, je.value.code, je.value.message)
