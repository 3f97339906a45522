"""The port's decode pipeline against the JAX package's staged walk, on the CPU.

* The frozen upload buffers of every chunk are byte-identical to those of
  the JAX `prepare_chunk_plan` run with its native fused walk switched off
  (PQT_FUSED_PREPARE=0), the walk the port copies.
* The port's DeviceColumns on device="cpu" equal the JAX
  `read_row_group_device` columns field by field, over a matrix of pyarrow
  files ({UNCOMPRESSED, GZIP} x data page {1.0, 2.0}) and the golden files
  the port's codecs read.
* DecodeStats counts what the JAX TpuDecodeStats counts, and
  backend="device_roundtrip" equals the JAX host decode.
"""

import io
from pathlib import Path

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

pytest.importorskip("torch")

import parquet_tpu.kernels.device_ops  # noqa: E402,F401  (turns x64 on first)
from parquet_tpu.core import chunk as jchunk  # noqa: E402
from parquet_tpu.core.reader import FileReader as JReader  # noqa: E402
from parquet_tpu.kernels import pipeline as jpipe  # noqa: E402

from parquet_tpu_torch.core.reader import FileReader  # noqa: E402
from parquet_tpu_torch.kernels import pipeline as tpipe  # noqa: E402
from parquet_tpu_torch.testing.parity import to_numpy  # noqa: E402

GOLDEN = Path(__file__).parent / "golden" / "data"
GOLDEN_READABLE = [
    "alltypes_plain_v1_none.parquet",
    "alltypes_v2_gzip.parquet",
    "delta_byte_array.parquet",
    "kv_metadata_and_empty_tail.parquet",
    "nulls_heavy.parquet",
    "foreign_bool_rle_shapes.parquet",
    "foreign_zero_row.parquet",
]
MATRIX = [(c, v) for c in ("NONE", "GZIP") for v in ("1.0", "2.0")]


@pytest.fixture(autouse=True)
def _staged_walk(monkeypatch):
    # the JAX reference runs its per-page Python walk, which the port copies
    monkeypatch.setenv("PQT_FUSED_PREPARE", "0")


def _table(n=24_000, seed=5):
    rng = np.random.default_rng(seed)
    keys = np.array([f"key-{i:05d}" for i in range(20_000)], dtype=object)
    return pa.table(
        {
            "plain_i64": pa.array(rng.integers(-(2**62), 2**62, n), pa.int64()),
            "dict_i32": pa.array(rng.integers(0, 300, n).astype(np.int32)),
            "dict_str": pa.array(keys[rng.integers(0, 20_000, n)].tolist(), pa.string()),
            "delta_i32": pa.array(rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32)),
            "delta_i64": pa.array(np.cumsum(rng.integers(-100, 10_000, n)).astype(np.int64)),
            "nullable_dict": pa.array(
                [None if x < 0.1 else int(x * 40) for x in rng.random(n)], pa.int32()
            ),
            "list_i32": pa.array(
                [list(range(int(k))) if k else None for k in rng.integers(0, 4, n)],
                pa.list_(pa.int32()),
            ),
            "dict_f64": pa.array(np.round(rng.random(n) * 100, 1)),
        }
    )


def _write(tmp_path, compression, version):
    path = tmp_path / f"m_{compression}_{version}.parquet"
    pq.write_table(
        _table(),
        path,
        compression=compression,
        data_page_version=version,
        use_dictionary=["dict_i32", "dict_str", "nullable_dict", "dict_f64"],
        column_encoding={
            "plain_i64": "PLAIN",
            "delta_i32": "DELTA_BINARY_PACKED",
            "delta_i64": "DELTA_BINARY_PACKED",
            "list_i32": "PLAIN",
        },
        data_page_size=16 << 10,
        row_group_size=10_000,
    )
    return path


CASES = [f"golden/{n}" for n in GOLDEN_READABLE] + [f"pyarrow/{c}/{v}" for c, v in MATRIX]


@pytest.fixture
def file_case(request, tmp_path):
    name = request.param
    if name.startswith("golden/"):
        return GOLDEN / name.split("/", 1)[1]
    _, c, v = name.split("/")
    return _write(tmp_path, c, v)


def _chunk_list(path):
    raw = Path(path).read_bytes()
    with JReader(io.BytesIO(raw)) as jr:
        for i in range(jr.num_row_groups):
            for cc in jr.row_group(i).columns:
                p = tuple(cc.meta_data.path_in_schema)
                yield raw, i, cc, jr.schema.column(p), p


def _assert_frozen_equal(tplan, jplan):
    assert len(tplan.frozen_hybrid) == len(jplan.frozen_hybrid)
    for t, j in zip(tplan.frozen_hybrid, jplan.frozen_hybrid):
        assert t.buf.tobytes() == j.buf.tobytes()
        assert (t.width, t.n_pad, t.run_pad, t.total) == (j.width, j.n_pad, j.run_pad, j.total)
    assert len(tplan.frozen_delta) == len(jplan.frozen_delta)
    for t, j in zip(tplan.frozen_delta, jplan.frozen_delta):
        assert t.meta32.tobytes() == j.meta32.tobytes()
        assert t.wide.dtype == j.wide.dtype and t.wide.tobytes() == j.wide.tobytes()
        assert (t.nbits, t.n_pad, t.m_pad, t.p_pad, t.total) == (
            j.nbits, j.n_pad, j.m_pad, j.p_pad, j.total
        )
    assert [pi[3] for pi in tplan.page_infos] == [pi[3] for pi in jplan.page_infos]
    tp, jp = tplan.plain_host, jplan.plain_host
    assert (tp is None) == (jp is None)
    if tp is not None:
        assert tp.dtype == jp.dtype and tp.tobytes() == jp.tobytes()


def _frozen_parity(path):
    from parquet_tpu_torch.core.schema import Schema
    from parquet_tpu_torch.meta.file_meta import read_file_metadata

    n = 0
    for raw, _i, cc, jcol, p in _chunk_list(path):
        jplan = jpipe.prepare_chunk_plan(io.BytesIO(raw), cc, jcol)
        schema = Schema.from_thrift(read_file_metadata(io.BytesIO(raw)).schema)
        tplan = tpipe.prepare_chunk_plan(io.BytesIO(raw), cc, schema.column(p))
        _assert_frozen_equal(tplan, jplan)
        n += len(tplan.frozen_hybrid) + len(tplan.frozen_delta)
    return n


@pytest.mark.parametrize("compression,version", MATRIX)
def test_frozen_buffers_byte_identical(tmp_path, compression, version):
    assert _frozen_parity(_write(tmp_path, compression, version)) >= 8


@pytest.mark.parametrize("cap_bytes", [5_000, 9_000])
def test_frozen_buffers_forced_batch_split(tmp_path, monkeypatch, cap_bytes):
    monkeypatch.setattr(jpipe, "_BATCH_BITS_CAP", cap_bytes * 8)
    monkeypatch.setattr(tpipe, "_BATCH_BITS_CAP", cap_bytes * 8)
    rng = np.random.default_rng(cap_bytes)
    n = 20_000
    t = pa.table(
        {
            "dict_i32": pa.array(rng.integers(0, 400, n).astype(np.int32)),
            "delta_i64": pa.array(np.cumsum(rng.integers(-100, 10_000, n)).astype(np.int64)),
        }
    )
    path = tmp_path / "split.parquet"
    pq.write_table(
        t, path, compression="GZIP", use_dictionary=["dict_i32"], data_page_size=2048,
        column_encoding={"delta_i64": "DELTA_BINARY_PACKED"},
    )
    batches = {}
    for raw, _i, cc, jcol, p in _chunk_list(path):
        jplan = jpipe.prepare_chunk_plan(io.BytesIO(raw), cc, jcol)
        batches[p[0]] = (len(jplan.frozen_hybrid), len(jplan.frozen_delta))
    assert batches["dict_i32"][0] > 1 and batches["delta_i64"][1] > 1
    assert _frozen_parity(path) == sum(sum(b) for b in batches.values())


def _assert_device_columns_equal(tcol, jcol):
    t = to_numpy(tcol)
    assert t["num_values"] == jcol.num_values
    for f in ("values", "indices", "data", "offsets", "dict_data", "dict_offsets"):
        a, b = t[f], getattr(jcol, f)
        assert (a is None) == (b is None), f
        if a is None:
            continue
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f
    for f in ("def_levels", "rep_levels"):
        a, b = t[f], getattr(jcol, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, np.asarray(b))
    a, b = t["dictionary"], jcol.dictionary
    assert (a is None) == (b is None)
    if a is not None:
        assert np.array_equal(a.offsets, b.offsets) and bytes(a.data) == bytes(b.data)


@pytest.mark.parametrize("file_case", CASES, indirect=True)
def test_device_columns_match_jax(file_case):
    with JReader(str(file_case), backend="tpu") as jr, FileReader(file_case, device="cpu") as tr:
        assert tr.num_row_groups == jr.num_row_groups
        jgroups = [jr.read_row_group_device(i) for i in range(jr.num_row_groups)]
        tgroups = tr.read_row_groups_device()
        for tg, jg in zip(tgroups, jgroups):
            assert tg.keys() == jg.keys()
            for p in tg:
                _assert_device_columns_equal(tg[p], jg[p])


@pytest.mark.parametrize("file_case", CASES, indirect=True)
def test_decode_stats_match_jax(file_case):
    raw = Path(file_case).read_bytes()
    jstats = jpipe.TpuDecodeStats()
    for raw, _i, cc, jcol, _p in _chunk_list(file_case):
        jpipe.plan_chunk_tpu(io.BytesIO(raw), cc, jcol, stats=jstats).device_column()
    with FileReader(file_case, device="cpu") as tr:
        tr.read_row_groups_device()
        assert tr.stats.__dict__ == jstats.__dict__


@pytest.mark.parametrize("file_case", CASES, indirect=True)
def test_device_roundtrip_matches_jax_host_decode(file_case):
    raw = Path(file_case).read_bytes()
    with FileReader(file_case, backend="device_roundtrip", device="cpu") as tr:
        groups = [tr.read_row_group(i) for i in range(tr.num_row_groups)]
    n = 0
    for raw, i, cc, jcol, p in _chunk_list(file_case):
        ref = jchunk.read_chunk(io.BytesIO(raw), cc, jcol)
        got = groups[i][p]
        assert got.num_values == ref.num_values
        for f in ("values", "def_levels", "rep_levels", "dictionary"):
            a, b = getattr(got, f), getattr(ref, f)
            assert (a is None) == (b is None), f
            if a is None:
                continue
            if hasattr(a, "offsets"):
                assert np.array_equal(a.offsets, b.offsets) and bytes(a.data) == bytes(b.data)
            else:
                a, b = np.asarray(a), np.asarray(b)
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
        n += 1
    assert n == sum(len(g) for g in groups)


def test_mixed_chunk_demotes_like_jax(tmp_path):
    # a dictionary that overflows mid-chunk leaves dict pages then PLAIN pages:
    # both packages demote the whole chunk to host decode and count the pages
    rng = np.random.default_rng(9)
    t = pa.table({"x": pa.array(rng.integers(0, 2**40, 30_000), pa.int64())})
    path = tmp_path / "mixed.parquet"
    pq.write_table(
        t, path, compression="NONE", dictionary_pagesize_limit=4096, data_page_size=4096
    )
    with JReader(str(path), backend="tpu") as jr, FileReader(path, device="cpu") as tr:
        j = jr.read_row_group_device(0)
        tcols = tr.read_row_group_device(0)
        _assert_device_columns_equal(tcols[("x",)], j[("x",)])
        assert tr.stats.host_fallback_pages > 0
    jstats = jpipe.TpuDecodeStats()
    for raw, _i, cc, jcol, _p in _chunk_list(path):
        jpipe.plan_chunk_tpu(io.BytesIO(raw), cc, jcol, stats=jstats)
    assert tr.stats.__dict__ == jstats.__dict__


def test_plan_requires_dispatch(tmp_path):
    path = _write(tmp_path, "NONE", "1.0")
    raw = path.read_bytes()
    _raw, _i, cc, _jcol, p = next(iter(_chunk_list(path)))
    with FileReader(path, device="cpu") as r:
        plan = tpipe.prepare_chunk_plan(io.BytesIO(raw), cc, r.schema.column(p))
    with pytest.raises(RuntimeError, match="dispatched"):
        plan.device_column()
    plan.dispatch_device("cpu")
    assert plan.dispatch_device("cpu") is plan  # idempotent
    assert plan.device_column().values.device.type == "cpu"
