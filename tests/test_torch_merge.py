"""The port's merge_files / split_row_groups against the JAX package's.

Files written by the port (dictionary, DELTA and PLAIN columns, snappy and
gzip, with bloom filters and a page index that the copies must drop) are
merged and split by both packages: every output is byte-identical, the
returned footers serialize alike, the merged file reads back through the
port's reader equal to its inputs, and the refusals (a schema or column
order mismatch, an output that is an input, a split pattern without %d,
groups_per_part < 1, no inputs) raise ParquetFileError with the JAX
package's message. A ByteSink output (MemorySink, BufferedSink) gets the
same bytes as a path.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import parquet_tpu.kernels.device_ops  # noqa: E402,F401  (turns x64 on first)
from parquet_tpu.core import merge as jmerge  # noqa: E402
from parquet_tpu.meta.file_meta import ParquetFileError as JError  # noqa: E402

import parquet_tpu_torch  # noqa: E402
from parquet_tpu_torch import FileReader, FileWriter, ParquetFileError, parse_schema  # noqa: E402
from parquet_tpu_torch.core import merge as tmerge  # noqa: E402
from parquet_tpu_torch.sink import BufferedSink, MemorySink  # noqa: E402

DSL = """message m { required int64 id; required int64 ts; optional double x;
  required binary s (STRING); }"""


def _write(path, seed, groups, **opts):
    rng = np.random.default_rng(seed)
    with FileWriter(path, parse_schema(DSL), column_encodings={"ts": "DELTA_BINARY_PACKED"},
                    **opts) as w:
        for g in range(groups):
            n = int(rng.integers(500, 1500))
            valid = rng.random(n) > 0.2
            w.write_column("id", rng.integers(0, 100, n).astype(np.int64))
            w.write_column("ts", np.cumsum(rng.integers(0, 1000, n)).astype(np.int64))
            w.write_column("x", rng.normal(size=int(valid.sum())), def_levels=valid.astype(np.uint16))
            w.write_column("s", np.array([f"s{int(k)}".encode() for k in rng.integers(0, 40, n)],
                                         dtype=object))
            w.flush_row_group()


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("merge")
    paths = [d / "a.parquet", d / "b.parquet", d / "c.parquet"]
    _write(paths[0], 1, 3, codec="snappy", bloom_filters=True, write_page_index=True)
    _write(paths[1], 2, 2, codec="gzip")
    _write(paths[2], 3, 1, codec="snappy", data_page_version=2, write_page_index=True)
    return d, paths


def _read_all(path):
    with FileReader(path, device="cpu") as r:
        out = []
        for i in range(r.num_row_groups):
            grp = r.read_row_group(i)
            out.append({p: (np.asarray(c.values.to_list() if hasattr(c.values, "offsets")
                                       else c.values, dtype=object),
                            None if c.def_levels is None else c.def_levels.copy())
                        for p, c in grp.items()})
        return out


def _same_groups(a, b):
    assert len(a) == len(b)
    for ga, gb in zip(a, b):
        assert ga.keys() == gb.keys()
        for p in ga:
            assert np.array_equal(ga[p][0], gb[p][0])
            if ga[p][1] is None:
                assert gb[p][1] is None
            else:
                assert np.array_equal(ga[p][1], gb[p][1])


@pytest.mark.parametrize("kv", [None, {"origin": "test", "n": "3"}])
def test_merge_matches_jax(inputs, kv):
    d, paths = inputs
    tout, jout = d / "t_merged.parquet", d / "j_merged.parquet"
    tmeta = tmerge.merge_files(tout, paths, key_value_metadata=kv)
    jmeta = jmerge.merge_files(str(jout), [str(p) for p in paths], key_value_metadata=kv)
    assert tout.read_bytes() == jout.read_bytes()
    assert tmeta.dumps() == jmeta.dumps()
    assert tmeta.num_rows == sum(FileReader(p, device="cpu").num_rows for p in paths)
    for rg in tmeta.row_groups:
        for cc in rg.columns:
            assert cc.meta_data.bloom_filter_offset is None and cc.column_index_offset is None
    _same_groups(_read_all(tout), [g for p in paths for g in _read_all(p)])


def test_merge_to_sinks_writes_the_same_bytes(inputs):
    d, paths = inputs
    ref = d / "ref.parquet"
    tmerge.merge_files(ref, paths, created_by="merger")
    mem = MemorySink()
    tmerge.merge_files(mem, paths, created_by="merger")
    inner = MemorySink()
    buf = BufferedSink(inner, spill_bytes=1000)
    tmerge.merge_files(buf, paths, created_by="merger")
    buf.close()
    assert mem.getvalue() == inner.getvalue() == ref.read_bytes()


@pytest.mark.parametrize("per_part", [1, 2, 5])
def test_split_matches_jax(inputs, per_part):
    d, paths = inputs
    merged = d / f"merged_{per_part}.parquet"
    tmerge.merge_files(merged, paths)
    tparts = tmerge.split_row_groups(merged, str(d / f"t_{per_part}_%d.parquet"), per_part)
    jparts = jmerge.split_row_groups(str(merged), str(d / f"j_{per_part}_%d.parquet"), per_part)
    assert len(tparts) == len(jparts) == -(-6 // per_part)
    for t, j in zip(tparts, jparts):
        with open(t, "rb") as ft, open(j, "rb") as fj:
            assert ft.read() == fj.read()
    again = d / f"again_{per_part}.parquet"
    tmerge.merge_files(again, tparts)
    _same_groups(_read_all(again), _read_all(merged))


def test_refusals_match_jax(inputs, tmp_path):
    d, paths = inputs
    other = tmp_path / "other.parquet"
    with FileWriter(other, parse_schema("message m { required int32 q; }")) as w:
        w.write_column("q", np.arange(5, dtype=np.int32))
    cases = [
        (lambda m: m.merge_files(str(tmp_path / "o.parquet"), []), "at least one"),
        (lambda m: m.merge_files(str(tmp_path / "o2.parquet"), [str(paths[0]), str(other)]),
         "schema mismatch"),
        (lambda m: m.merge_files(str(paths[1]), [str(paths[0]), str(paths[1])]), "also an input"),
        (lambda m: m.split_row_groups(str(paths[0]), str(tmp_path / "x.parquet")), "%d"),
        (lambda m: m.split_row_groups(str(paths[0]), str(tmp_path / "x%d.parquet"), 0), ">= 1"),
    ]
    for call, frag in cases:
        with pytest.raises(ParquetFileError) as t_err:
            call(tmerge)
        with pytest.raises(JError) as j_err:
            call(jmerge)
        assert str(t_err.value) == str(j_err.value)
        assert frag in str(t_err.value)
    assert not (tmp_path / "o2.parquet").exists()  # an aborted merge leaves no file


def test_exported_from_the_package():
    assert parquet_tpu_torch.merge_files is tmerge.merge_files
    assert parquet_tpu_torch.split_row_groups is tmerge.split_row_groups
