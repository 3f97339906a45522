"""The port's page index read side against the JAX package's, on the CPU.

read_page_index (every chunk's ColumnIndex and OffsetIndex, byte for byte
once re-serialized) and prune_pages (the row ranges a filter's pages may
hold) equal the JAX package's on files the port's FileWriter writes, files
the JAX FileWriter writes and a pyarrow write_page_index=True file: sorted,
clustered and random leaves, an optional leaf with an all-null page,
strings, doubles with NaN, pages of a few hundred rows, and filters of
every comparison, in-lists, null tests and OR-of-ANDs. Every row NumPy
finds matching lies inside the kept ranges. Files without a page index
keep whole groups, and a corrupt index raises ParquetFileError in both.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import parquet_tpu.kernels.device_ops  # noqa: E402,F401  (turns x64 on first)
from parquet_tpu.core.reader import FileReader as JReader  # noqa: E402
from parquet_tpu.core.writer import FileWriter as JWriter  # noqa: E402
from parquet_tpu.schema.dsl import parse_schema as j_parse_schema  # noqa: E402

import parquet_tpu_torch  # noqa: E402
from parquet_tpu_torch import FileReader, FileWriter, parse_schema  # noqa: E402
from parquet_tpu_torch.core import filter as tfilter  # noqa: E402

DSL = """message p {
  required int64 id;
  required int32 cluster;
  optional int32 v;
  required double x;
  required binary s (STRING);
}"""
N, GROUPS = 4000, 2


def _columns(seed: int = 41):
    rng = np.random.default_rng(seed)
    groups = []
    for g in range(GROUPS):
        valid = rng.random(N) >= 0.3
        valid[:900] = False  # an all-null page at the group's start
        x = np.round(rng.normal(size=N), 3)
        x[rng.integers(0, N, 5)] = np.nan
        groups.append({
            "id": np.arange(N, dtype=np.int64) + g * N,
            "cluster": np.sort(rng.integers(0, 50, N)).astype(np.int32)[::-1 if g else 1].copy(),
            "v": (rng.integers(-100, 100, int(valid.sum())).astype(np.int32), valid),
            "x": x,
            "s": np.array([f"k{int(k):04d}".encode() for k in np.sort(rng.integers(0, 2000, N))],
                          dtype=object),
        })
    return groups


COLUMNS = _columns()


def _write(W, path, schema, **opts):
    with W(str(path), schema, write_page_index=True, max_page_size=2048, **opts) as w:
        for grp in COLUMNS:
            for leaf, v in grp.items():
                if isinstance(v, tuple):
                    w.write_column(leaf, v[0], def_levels=v[1].astype(np.uint16))
                else:
                    w.write_column(leaf, v)
            w.flush_row_group()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    import pyarrow as pa
    import pyarrow.parquet as pq

    d = tmp_path_factory.mktemp("pages")
    out = {"port": d / "port.parquet", "jax": d / "jax.parquet",
           "port_v2": d / "port_v2.parquet", "pyarrow": d / "pyarrow.parquet",
           "no_index": d / "no_index.parquet"}
    _write(FileWriter, out["port"], parse_schema(DSL))
    _write(FileWriter, out["port_v2"], parse_schema(DSL), data_page_version=2, codec="gzip",
           use_dictionary=False)
    _write(JWriter, out["jax"], j_parse_schema(DSL))
    assert out["port"].read_bytes() == out["jax"].read_bytes()
    tables = []
    for grp in COLUMNS:
        vals, valid = grp["v"]
        v = np.zeros(N, dtype=np.int32)
        v[valid] = vals
        tables.append(pa.table({
            "id": grp["id"], "cluster": grp["cluster"],
            "v": pa.array(v, mask=~valid), "x": grp["x"],
            "s": pa.array([b.decode() for b in grp["s"]]),
        }))
    pq.write_table(pa.concat_tables(tables), out["pyarrow"], row_group_size=N,
                   data_page_size=2048, write_page_index=True, write_batch_size=256)
    with FileWriter(str(out["no_index"]), parse_schema(DSL)) as w:
        for leaf, v in COLUMNS[0].items():
            if isinstance(v, tuple):
                w.write_column(leaf, v[0], def_levels=v[1].astype(np.uint16))
            else:
                w.write_column(leaf, v)
    return out


FILTERS = {
    "id_range": [("id", ">=", 1000), ("id", "<", 1500)],
    "id_eq": [("id", "==", 2500)],
    "id_absent": [("id", ">", 10**9)],
    "cluster_le": [("cluster", "<=", 3)],
    "cluster_in": [("cluster", "in", [10, 11, 40])],
    "cluster_ne": [("cluster", "!=", 7)],
    "v_null": [("v", "is_null", None)],
    "v_not_null": [("v", "not_null", None)],
    "v_gt": [("v", ">", 95)],
    "x_range": [("x", ">", 2.5)],
    "s_range": [("s", ">=", "k1500"), ("s", "<", "k1600")],
    "s_eq": [("s", "==", "k0042")],
    "dnf": [[("id", "<", 300)], [("cluster", ">=", 45), ("s", ">", "k1900")]],
    "dnf_all": [[("id", ">=", 0)], [("cluster", "==", 1)]],
}


def _index_bytes(idx: dict) -> dict:
    return {p: tuple(None if x is None else x.dumps() for x in pair) for p, pair in idx.items()}


@pytest.mark.parametrize("name", ["port", "jax", "port_v2", "pyarrow", "no_index"])
def test_read_page_index_matches_jax(files, name):
    with FileReader(files[name], device="cpu") as tr, JReader(str(files[name])) as jr:
        for g in range(tr.num_row_groups):
            got = _index_bytes(tr.read_page_index(g))
            assert got == _index_bytes(jr.read_page_index(g))
            if name == "no_index":
                assert all(pair == (None, None) for pair in got.values())
            else:
                assert all(None not in pair for pair in got.values())
            sel = tr.read_page_index(g, columns=["id", "s"])
            assert sorted(sel) == [("id",), ("s",)]


def _numpy_matches(g: int, name: str):
    grp = COLUMNS[g]
    vals, valid = grp["v"]
    v = np.zeros(N, dtype=np.int32)
    v[valid] = vals
    cols = {"id": grp["id"], "cluster": grp["cluster"], "x": grp["x"], "v": v,
            "s": np.array([b.decode() for b in grp["s"]])}
    ops = {"==": np.equal, "!=": np.not_equal, "<": np.less, "<=": np.less_equal,
           ">": np.greater, ">=": np.greater_equal}

    def conj(c):
        keep = np.ones(N, dtype=bool)
        for col, op, val in c:
            present = valid if col == "v" else np.ones(N, dtype=bool)
            if op == "is_null":
                keep &= ~present
            elif op == "not_null":
                keep &= present
            elif op == "in":
                keep &= present & np.isin(cols[col], val)
            else:
                keep &= present & ops[op](cols[col], val)
        return keep

    f = FILTERS[name]
    if isinstance(f[0], list):
        return np.logical_or.reduce([conj(c) for c in f])
    return conj(f)


@pytest.mark.parametrize("name", ["port", "jax", "port_v2", "pyarrow", "no_index"])
@pytest.mark.parametrize("flt", sorted(FILTERS))
def test_prune_pages_matches_jax_and_keeps_every_match(files, name, flt):
    with FileReader(files[name], device="cpu") as tr, JReader(str(files[name])) as jr:
        for g in range(tr.num_row_groups):
            got = tr.prune_pages(g, FILTERS[flt])
            assert got == jr.prune_pages(g, FILTERS[flt])
            rows = tr.row_group(g).num_rows
            if name == "no_index":
                assert got == [(0, rows)]
            assert all(0 <= a < b <= rows for a, b in got)
            assert all(b1 < a2 for (_, b1), (a2, _) in zip(got, got[1:]))  # sorted, coalesced
            kept = np.zeros(rows, dtype=bool)
            for a, b in got:
                kept[a:b] = True
            match = _numpy_matches(g, flt)
            assert not (match & ~kept).any(), f"a matching row outside the kept ranges ({flt})"


def test_range_filters_on_sorted_leaves_drop_pages(files):
    with FileReader(files["port"], device="cpu") as r:
        for flt in ("id_range", "id_eq", "s_range", "v_gt", "cluster_le"):
            kept = sum(b - a for a, b in r.prune_pages(0, FILTERS[flt]))
            assert kept < r.row_group(0).num_rows, flt
        assert r.prune_pages(0, FILTERS["id_absent"]) == []
        assert r.prune_pages(0, FILTERS["dnf_all"]) == [(0, N)]


def test_page_range_helpers_match_jax():
    from parquet_tpu.core import filter as jfilter

    a = [(0, 10), (20, 30), (40, 50)]
    b = [(5, 25), (28, 45)]
    assert tfilter._intersect_ranges(a, b) == jfilter._intersect_ranges(a, b)
    rs = [(0, 5), (5, 9), (12, 20), (15, 18), (30, 31)]
    assert tfilter._coalesce_ranges(rs) == jfilter._coalesce_ranges(rs)


def test_malformed_foreign_indexes_keep_the_group():
    """A ColumnIndex whose lists disagree with the OffsetIndex prunes
    nothing in either package."""
    from parquet_tpu.core import filter as jfilter
    from parquet_tpu.meta import parquet_types as jpt
    from parquet_tpu_torch.meta import parquet_types as tpt

    for pt, flt, schema in ((tpt, tfilter, parse_schema(DSL)),
                            (jpt, jfilter, j_parse_schema(DSL))):
        ci = pt.ColumnIndex(null_pages=[False], min_values=[b"\x00" * 8], max_values=[b"\x01" * 8],
                            boundary_order=0)
        oi = pt.OffsetIndex(page_locations=[
            pt.PageLocation(offset=4, compressed_page_size=10, first_row_index=0),
            pt.PageLocation(offset=14, compressed_page_size=10, first_row_index=5)])
        dnf = flt.normalize_dnf(schema, [("id", "==", 99)])
        assert flt.dnf_page_ranges(dnf, {("id",): (ci, oi)}, 10) == [(0, 10)]


def test_corrupt_index_raises_like_jax(files, tmp_path):
    raw = bytearray(files["port"].read_bytes())
    with FileReader(files["port"], device="cpu") as r:
        cc = r.row_group(0).columns[0]
        off, length = cc.column_index_offset, cc.column_index_length
    raw[off:off + length] = b"\xff" * length
    bad = tmp_path / "bad.parquet"
    bad.write_bytes(bytes(raw))
    with FileReader(bad, device="cpu") as tr:
        with pytest.raises(parquet_tpu_torch.ParquetFileError, match="corrupt page index"):
            tr.read_page_index(0)
    from parquet_tpu.meta.file_meta import ParquetFileError as JError

    with JReader(str(bad)) as jr:
        with pytest.raises(JError, match="corrupt page index"):
            jr.read_page_index(0)
