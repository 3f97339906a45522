"""Filtered host rows: the port's iter_rows(filters=) and its page-range
decode against the JAX package.

The same files go through both packages' FileReader.iter_rows(filters=):
the type zoo of tests/test_filter_vec.py (pyarrow-written: ints, unsigned,
floats with NaN, strings, binaries with NULs, int- and binary-backed
decimals, timestamps, dates, booleans, LIST `contains`) under its filters
and the 60-predicate sweep of tests/test_torch_filter.py, whole and
projected; files written by the JAX FileWriter with and without a page
index, where selective page decode engages (few flat rows admitted) and
declines (most rows admitted, or a LIST column selected); projections that
leave filter columns out (the strip, leaf-granular); and raw=True, which
both refuse with FilterError. read_chunk_row_ranges gives the JAX chunks.
Every test runs under both engines (PQT_VEC_ASSEMBLY and PQT_VEC_FILTER at
1 and at 0); rows compare exactly.
"""

import functools
import io

import numpy as np
import pytest

pytest.importorskip("torch")

import parquet_tpu.kernels.device_ops  # noqa: E402,F401  (turns x64 on first)
from parquet_tpu.core.chunk import read_chunk_row_ranges as j_read_chunk_row_ranges  # noqa: E402
from parquet_tpu.core.filter import FilterError as JFilterError  # noqa: E402
from parquet_tpu.core.reader import FileReader as JReader  # noqa: E402
from parquet_tpu.core.writer import FileWriter as JWriter  # noqa: E402
from parquet_tpu.schema.dsl import parse_schema as j_parse_schema  # noqa: E402
from parquet_tpu.sink import MemorySink as JMemorySink  # noqa: E402
from tests.test_filter_vec import ZOO_FILTERS, zoo  # noqa: E402,F401
from tests.test_torch_rows import engine, jax_rows, port_rows  # noqa: E402,F401

import parquet_tpu_torch  # noqa: E402
from parquet_tpu_torch import FileReader, FilterError  # noqa: E402
from parquet_tpu_torch.core.chunk import read_chunk_row_ranges  # noqa: E402

ZOO_IDS = [str(f) for f in ZOO_FILTERS]


def both(data, filters, columns=None, row_groups=None):
    """(JAX rows, port rows, the port's row counts) of one filtered read."""
    read = {"columns": columns} if columns else {}
    want = jax_rows(data, filters=filters, row_groups=row_groups, read=read)
    parquet_tpu_torch.reset_row_counts()
    got = port_rows(data, filters=filters, row_groups=row_groups, read=read)
    return want, got, parquet_tpu_torch.row_counts()


@pytest.fixture(scope="module")
def zoo_bytes(zoo):  # noqa: F811
    with open(zoo, "rb") as f:
        return f.read()


@pytest.mark.parametrize("columns", [None, ["i32"], ["s", "tags"]], ids=["all", "i32", "s+tags"])
@pytest.mark.parametrize("filt", ZOO_FILTERS, ids=ZOO_IDS)
def test_zoo_filters_match_jax(zoo_bytes, filt, columns):
    want, got, _ = both(zoo_bytes, filt, columns)
    assert got == want


def test_zoo_sweep_matches_jax(zoo_bytes):
    """The 60-predicate sweep of test_device_query's TestExtendedSweep."""
    rng = np.random.default_rng(77)
    ops = ["==", "!=", "<", "<=", ">", ">="]
    cols = [
        ("i32", lambda: int(rng.integers(-10, 810))),
        ("i64", lambda: int(rng.integers(-500, 500))),
        ("u32", lambda: (1 << 31) + int(rng.integers(0, 800))),
        ("f", lambda: float(rng.standard_normal())),
        ("s", lambda: f"v{int(rng.integers(0, 25))}"),
    ]
    kept = 0
    for _ in range(60):
        conj = []
        for _ in range(int(rng.integers(1, 4))):
            name, gen = cols[int(rng.integers(0, len(cols)))]
            conj.append((name, ops[int(rng.integers(0, len(ops)))], gen()))
        want, got, _ = both(zoo_bytes, [conj])
        assert got == want, conj
        kept += len(want)
    assert kept > 1000


def test_engine_counts(zoo_bytes, engine):  # noqa: F811
    n = 800
    want, got, c = both(zoo_bytes, [("i32", ">", 100)])
    assert got == want and len(got) == n - 101
    if engine == "1":
        assert c.get("rows_filtered_vec") == 101 and not c.get("rows_filtered_scalar")
        assert c.get("assemble_vec") and not c.get("assemble_cursor")
    else:
        assert c.get("rows_filtered_scalar") == 101 and not c.get("rows_filtered_vec")
        assert c.get("assemble_cursor") and not c.get("assemble_vec")
    # binary-backed decimals have no orderable physical form: the mask
    # declines and the scalar walk filters, under either switch
    import decimal

    want, got, c = both(zoo_bytes, [("bigdec", ">", decimal.Decimal("1.0"))])
    assert got == want and c.get("rows_filtered_scalar") and not c.get("rows_filtered_vec")


def test_raw_rows_refuse_filters_in_both(zoo_bytes):
    with pytest.raises(FilterError):
        with FileReader(zoo_bytes, device="cpu") as r:
            list(r.iter_rows(raw=True, filters=[("i32", ">", 1)]))
    with pytest.raises(JFilterError):
        with JReader(io.BytesIO(zoo_bytes)) as r:
            list(r.iter_rows(raw=True, filters=[("i32", ">", 1)]))


# -- the page index: selective page decode --------------------------------------

INDEX_DSL = """message m {
  required int64 k;
  optional int32 v;
  optional binary s (STRING);
  required double x;
  optional group tags (LIST) { repeated group list { required int32 element; } }
  optional group g { optional int32 b; optional int64 c; }
}"""
INDEX_ROWS = 6000


def index_rows():
    rng = np.random.default_rng(41)
    rows = []
    for i in range(INDEX_ROWS):
        rows.append({
            "k": i,
            "v": None if rng.random() < 0.2 else int(rng.integers(-50, 50)),
            "s": None if rng.random() < 0.1 else f"s{int(rng.integers(0, 40))}",
            "x": float(rng.standard_normal()),
            "tags": None if rng.random() < 0.1 else [int(t) for t in rng.integers(0, 9, int(rng.integers(0, 3)))],
            "g": None if rng.random() < 0.1 else {"b": int(rng.integers(0, 5)),
                                                  "c": None if rng.random() < 0.3 else i},
        })
    return rows


@functools.lru_cache(maxsize=None)
def written_index_file(with_index: bool) -> bytes:
    sink = JMemorySink()
    w = JWriter(sink, j_parse_schema(INDEX_DSL), max_page_size=1024, use_dictionary=False,
                write_page_index=with_index, row_group_size=60_000)
    w.write_rows(index_rows())
    w.close()
    return sink.getvalue()


@pytest.fixture(scope="module", params=[True, False], ids=["page_index", "no_index"])
def index_file(request):
    return request.param, written_index_file(request.param)


INDEX_CASES = {
    # (filters, columns, selective page decode expected with an index)
    "few rows, flat": ([("k", "<", 150)], ["k", "v", "s", "x"], True),
    "two windows": ([[("k", "<", 100)], [("k", ">=", 5900)]], ["k", "s"], True),
    "few rows, nested strip": ([("k", "<", 150), ("g.c", "not_null")], ["k", "g.b"], True),
    "most rows": ([("k", ">=", 100)], ["k", "v"], False),
    "list selected": ([("k", "<", 150)], ["k", "tags"], False),
    "all columns": ([("k", "<", 150)], None, False),
    "value filter": ([("v", "==", 3), ("k", "<", 300)], ["v", "s"], True),
    "nothing admitted": ([("k", ">", 10**9)], ["k"], False),
}


@pytest.mark.parametrize("case", list(INDEX_CASES), ids=list(INDEX_CASES))
def test_page_index_filters_match_jax(index_file, case):
    has_index, data = index_file
    filters, columns, selective = INDEX_CASES[case]
    want, got, c = both(data, filters, columns)
    assert got == want
    assert bool(c.get("selective_page_decode")) == (selective and has_index)


def test_index_file_has_several_groups_and_pages(index_file):
    has_index, data = index_file
    with FileReader(data, device="cpu") as r:
        assert r.num_row_groups > 1
        if has_index:
            _ci, oi = r.read_page_index(0)[("k",)]
            assert len(oi.page_locations) > 4


STRIP_CASES = [
    ([("s", "==", "s3")], ["k"]),
    ([("g.c", ">", 100)], ["g.b"]),
    ([("g.c", ">", 100), ("tags", "contains", 3)], ["k", "g"]),
    ([[("v", "<", 0)], [("x", ">", 1.0)]], ["s"]),
]


@pytest.mark.parametrize("filt,columns", STRIP_CASES, ids=[str(c) for c in STRIP_CASES])
def test_projection_strips_filter_columns_like_jax(index_file, filt, columns):
    _has_index, data = index_file
    want, got, _ = both(data, filt, columns)
    assert got == want and got
    with FileReader(data, device="cpu", columns=columns) as r:
        tops = {c.split(".")[0] for c in columns}
        assert all(set(row) <= tops for row in r.iter_rows(filters=filt))


@pytest.mark.parametrize("ranges", [[(0, 10)], [(37, 900), (1500, 1501), (2990, 3000)], [(0, 3000)]])
def test_read_chunk_row_ranges_matches_jax(ranges):
    data = written_index_file(True)
    with FileReader(data, device="cpu") as r, JReader(io.BytesIO(data)) as jr:
        n = r.row_group(0).num_rows
        ranges = [(a, min(b, n)) for a, b in ranges if a < n]
        idx, jidx = r.read_page_index(0), jr.read_page_index(0)
        flat = [(p, cc, col) for p, cc, col in r._selected_chunks(0) if col.max_rep == 0]
        assert len(flat) == 6
        for path, cc, col in flat:
            got = read_chunk_row_ranges(io.BytesIO(data), cc, col, idx[path][1], ranges, n)
            want = j_read_chunk_row_ranges(io.BytesIO(data), cc, jr.schema.column(path),
                                           jidx[path][1], ranges, n)
            assert got.num_values == want.num_values == sum(b - a for a, b in ranges)
            for f in ("def_levels", "rep_levels"):
                a, b = getattr(got, f), getattr(want, f)
                assert (a is None) == (b is None) and (a is None or np.array_equal(a, b)), f
            a, b = got.values, want.values
            if hasattr(a, "offsets"):
                assert np.array_equal(a.offsets, b.offsets) and bytes(a.data) == bytes(b.data)
            else:
                assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
