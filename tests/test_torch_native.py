"""The port's fused native prepare walk against the JAX package's, on the CPU.

* The port's host library (parquet_tpu_torch/native/prepare.cc, built with
  g++ at first use) returns the same ptq_chunk_prepare tables as the JAX
  package's native library on the same chunk bytes, field by field.
* The plans of both packages' prepare_chunk_plan are equal: page_infos,
  byte-identical frozen upload buffers and BSS staging, and DecodeStats equal
  to TpuDecodeStats, over the kind x codec x page version matrix of
  tests/test_fused_prepare.py plus LZ4_RAW.
* The fused -> staged -> raise ladder: a corrupted page header or snappy
  block aborts the port's walk at the same stage as the reference's; the
  chunk then recovers on the staged walk or raises the same typed error.
* The port's snappy and LZ4 codecs round-trip against the reference's.
"""

import io
import os
from contextlib import contextmanager

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

pytest.importorskip("torch")

import parquet_tpu.kernels.device_ops  # noqa: E402,F401  (turns x64 on first)
from parquet_tpu.core import compress as jcompress  # noqa: E402
from parquet_tpu.core.reader import FileReader as JReader  # noqa: E402
from parquet_tpu.kernels import pipeline as jpipe  # noqa: E402
from parquet_tpu.meta.parquet_types import CompressionCodec  # noqa: E402
from parquet_tpu.utils.native import get_native as j_native  # noqa: E402
from parquet_tpu.utils.trace import decode_trace  # noqa: E402

import parquet_tpu_torch  # noqa: E402
from parquet_tpu_torch.core import compress as tcompress  # noqa: E402
from parquet_tpu_torch.core.chunk import chunk_byte_range  # noqa: E402
from parquet_tpu_torch.core.reader import FileReader  # noqa: E402
from parquet_tpu_torch.kernels import pipeline as tpipe  # noqa: E402
from parquet_tpu_torch.testing.synth import ColumnSpec, write_file  # noqa: E402
from parquet_tpu_torch.utils import native as tnative  # noqa: E402

ROWS = 20_000
KINDS = [
    "plain_i64",
    "plain_f32",
    "dict_str",
    "delta_i64",
    "bss_f32",
    "nullable_i64",
    "nested_list",
]
CODECS = ["none", "snappy", "gzip", "lz4"]  # pyarrow's "lz4" is LZ4_RAW
VERSIONS = ["1.0", "2.0"]


@contextmanager
def _env(**kv):
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update(kv)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _column(kind):
    """(arrow array, write kwargs): tests/test_fused_prepare.py's shapes."""
    rng = np.random.default_rng(11)
    if kind == "plain_i64":
        return pa.array(rng.integers(-(1 << 40), 1 << 40, ROWS), pa.int64()), {
            "use_dictionary": False, "column_encoding": {"v": "PLAIN"},
        }
    if kind == "plain_f32":
        return pa.array(rng.random(ROWS).astype(np.float32)), {
            "use_dictionary": False, "column_encoding": {"v": "PLAIN"},
        }
    if kind == "dict_str":
        return pa.array([f"val_{i % 97}" for i in range(ROWS)]), {"use_dictionary": ["v"]}
    if kind == "delta_i64":
        return pa.array(np.cumsum(rng.integers(0, 50, ROWS)).astype(np.int64)), {
            "use_dictionary": False, "column_encoding": {"v": "DELTA_BINARY_PACKED"},
        }
    if kind == "bss_f32":
        return pa.array(rng.random(ROWS).astype(np.float32)), {
            "use_dictionary": False, "column_encoding": {"v": "BYTE_STREAM_SPLIT"},
        }
    if kind == "nullable_i64":
        mask = rng.random(ROWS) < 0.25
        return pa.array(rng.integers(0, 1 << 30, ROWS), pa.int64(), mask=mask), {
            "use_dictionary": False, "column_encoding": {"v": "PLAIN"},
        }
    if kind == "nested_list":
        lengths = rng.integers(0, 5, ROWS // 4)
        vals = rng.integers(0, 1 << 20, int(lengths.sum())).astype(np.int32)
        offs = np.zeros(len(lengths) + 1, dtype=np.int64)
        np.cumsum(lengths, out=offs[1:])
        rows = [
            None if i % 7 == 0 else vals[offs[i] : offs[i + 1]].tolist()
            for i in range(len(lengths))
        ]
        return pa.array(rows, pa.list_(pa.int32())), {"use_dictionary": False}
    raise AssertionError(kind)


def _build(tmp_path, kind, codec, version):
    arr, kw = _column(kind)
    p = tmp_path / f"{kind}_{codec}_{version.replace('.', '')}.parquet"
    pq.write_table(
        pa.table({"v": arr}), p, compression=codec, data_page_version=version,
        row_group_size=ROWS // 3, **kw,
    )
    return p


def _chunks(raw):
    """(ColumnChunk, JAX column, port column) for every chunk of a file."""
    from parquet_tpu_torch.core.schema import Schema
    from parquet_tpu_torch.meta.file_meta import read_file_metadata

    tschema = Schema.from_thrift(read_file_metadata(io.BytesIO(raw)).schema)
    with JReader(io.BytesIO(raw)) as jr:
        for i in range(jr.num_row_groups):
            for cc in jr.row_group(i).columns:
                p = tuple(cc.meta_data.path_in_schema)
                yield cc, jr.schema.column(p), tschema.column(p)


def _prepare_args(raw, cc, col):
    md = cc.meta_data
    off, total = chunk_byte_range(cc)
    np_dt = tpipe._NUMERIC_DTYPE.get(col.type)
    nbits = {"INT32": 32, "INT64": 64}.get(col.type.name, 0)
    return (
        raw[off : off + total], int(md.codec or 0), col.max_def, col.max_rep,
        np.dtype(np_dt).itemsize if np_dt is not None else 0, nbits,
        int(md.num_values or 0), int(md.total_uncompressed_size or 0),
    )


_TABLE_KEYS = (
    "pages", "def", "rep", "values", "packed", "delta_stream", "h_is_rle",
    "h_counts", "h_values", "h_byteoff", "d_widths", "d_bytestart",
    "d_outstart", "d_mins", "has_dict",
)


def _assert_tables_equal(t, j, ctx):
    for key in _TABLE_KEYS:
        a, b = t[key], j[key]
        if a is None or b is None or isinstance(a, bool):
            assert a is None and b is None or a == b, (ctx, key)
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, (ctx, key)
        assert a.tobytes() == b.tobytes(), (ctx, key)


def _same(a, b):
    if a is None or b is None:
        return a is None and b is None
    if hasattr(a, "offsets"):
        return (
            hasattr(b, "offsets")
            and np.array_equal(a.offsets, b.offsets)
            and bytes(a.data) == bytes(b.data)
        )
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _assert_plans_equal(tplan, jplan, ctx):
    assert len(tplan.page_infos) == len(jplan.page_infos), ctx
    for tp, jp in zip(tplan.page_infos, jplan.page_infos):
        assert tp[0] == jp[0] and tp[3] == jp[3], (ctx, tp[3], jp[3])
        assert _same(tp[1], jp[1]) and _same(tp[2], jp[2]), ctx
        if tp[3] in ("values", "indices"):
            assert _same(tp[4], jp[4]), ctx
        else:
            assert tp[4] == jp[4], ctx
    assert _same(tplan.native_def, jplan.native_def), ctx
    assert _same(tplan.native_rep, jplan.native_rep), ctx
    assert _same(tplan.dictionary, jplan.dictionary), ctx
    assert len(tplan.frozen_hybrid) == len(jplan.frozen_hybrid), ctx
    for t, j in zip(tplan.frozen_hybrid, jplan.frozen_hybrid):
        assert t.buf.tobytes() == j.buf.tobytes(), ctx
        assert (t.width, t.n_pad, t.run_pad, t.total) == (j.width, j.n_pad, j.run_pad, j.total)
    assert len(tplan.frozen_delta) == len(jplan.frozen_delta), ctx
    for t, j in zip(tplan.frozen_delta, jplan.frozen_delta):
        assert t.meta32.tobytes() == j.meta32.tobytes(), ctx
        assert t.wide.dtype == j.wide.dtype and t.wide.tobytes() == j.wide.tobytes(), ctx
        assert (t.nbits, t.n_pad, t.m_pad, t.p_pad, t.total) == (
            j.nbits, j.n_pad, j.m_pad, j.p_pad, j.total
        ), ctx
    assert len(tplan.bss_host) == len(jplan.bss_host), ctx
    for (ts, tn), (js, jn) in zip(tplan.bss_host, jplan.bss_host):
        assert tn == jn and ts.shape == js.shape and ts.tobytes() == js.tobytes(), ctx
    assert _same(tplan.plain_host, jplan.plain_host), ctx


def _stats_tuple(s):
    return (s.pages, s.device_values, s.host_fallback_pages, s.device_batches)


def _plan_parity(raw, ctx):
    """Both packages' fused plans for every chunk, compared; the port's
    counters say the fused walk took every chunk."""
    tpipe.reset_prepare_counts()
    n = 0
    for cc, jcol, tcol in _chunks(raw):
        args = _prepare_args(raw, cc, tcol)
        jt = j_native().chunk_prepare(*args)
        tt = tnative.get_native().chunk_prepare(*args)
        _assert_tables_equal(tt, jt, ctx)
        jstats, tstats = jpipe.TpuDecodeStats(), tpipe.DecodeStats()
        jplan = jpipe.prepare_chunk_plan(io.BytesIO(raw), cc, jcol, stats=jstats)
        tplan = tpipe.prepare_chunk_plan(io.BytesIO(raw), cc, tcol, stats=tstats)
        _assert_plans_equal(tplan, jplan, ctx)
        jplan.dispatch_device()
        tplan.dispatch_device("cpu")
        assert _stats_tuple(tstats) == (
            jstats.pages, jstats.device_values, jstats.host_fallback_pages,
            jstats.device_batches,
        ), ctx
        n += 1
    counts = tpipe.prepare_counts()
    assert counts.get("prepare_fused_engaged") == n, (ctx, counts)
    assert not counts.get("prepare_fused_declined"), (ctx, counts)
    return n


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("version", VERSIONS)
@pytest.mark.parametrize("kind", KINDS)
def test_fused_tables_and_plans_match_reference(tmp_path, kind, codec, version):
    raw = _build(tmp_path, kind, codec, version).read_bytes()
    assert _plan_parity(raw, (kind, codec, version)) >= 1


def test_legacy_lz4_hadoop_framing_matches_reference(tmp_path):
    # codec 5 (Hadoop-framed LZ4), as the port's own writer frames it
    rng = np.random.default_rng(7)
    specs = [
        ColumnSpec("a", parquet_tpu_torch.meta.parquet_types.Type.INT64,
                   values=np.cumsum(rng.integers(0, 9, 50_000)).astype(np.int64),
                   codec=CompressionCodec.LZ4),
        ColumnSpec("b", parquet_tpu_torch.meta.parquet_types.Type.INT32,
                   values=rng.integers(0, 5, 50_000).astype(np.int32),
                   codec=CompressionCodec.LZ4, page_version=2),
    ]
    buf = io.BytesIO()
    write_file(buf, specs, row_group_rows=20_000, page_bytes=64 << 10)
    assert _plan_parity(buf.getvalue(), "lz4-hadoop") == 6


def test_staged_switch_forces_both_walks(tmp_path):
    raw = _build(tmp_path, "dict_str", "snappy", "1.0").read_bytes()
    tpipe.reset_prepare_counts()
    with _env(PQT_FUSED_PREPARE="0"), decode_trace() as tr:
        for cc, jcol, tcol in _chunks(raw):
            jplan = jpipe.prepare_chunk_plan(io.BytesIO(raw), cc, jcol)
            tplan = tpipe.prepare_chunk_plan(io.BytesIO(raw), cc, tcol)
            assert tplan.native_def is None and jplan.native_def is None
            assert [p[3] for p in tplan.page_infos] == [p[3] for p in jplan.page_infos]
    assert tpipe.prepare_counts() == {}
    assert "prepare_fused_engaged" not in tr.stages


def _corrupt_file(tmp_path):
    """A snappy file with two data pages per chunk, and the byte offsets of
    the first data page's header and of its snappy block."""
    path = tmp_path / "c.parquet"
    t = pa.table({"v": pa.array(np.arange(30_000, dtype=np.int64) * 7)})
    pq.write_table(t, path, compression="snappy", use_dictionary=False,
                   data_page_size=64 << 10, row_group_size=30_000)
    raw = bytearray(path.read_bytes())
    with JReader(io.BytesIO(bytes(raw))) as jr:
        off, _total = chunk_byte_range(jr.row_group(0).columns[0])
    header_len = int(j_native().parse_page_header(bytes(raw[off : off + 4096]))[0])
    return raw, off, off + header_len


def _ladder(raw, ctx):
    """(the port's fault stage, its outcome) against the reference's."""
    outcomes = []
    for pkg in ("jax", "torch"):
        tpipe.reset_prepare_counts()
        with decode_trace() as tr:
            for cc, jcol, tcol in _chunks(bytes(raw)):
                args = _prepare_args(bytes(raw), cc, tcol)
                lib = j_native() if pkg == "jax" else tnative.get_native()
                fault = lib.chunk_prepare(*args)
                assert not isinstance(fault, dict), (ctx, pkg)  # the walk aborted
                try:
                    if pkg == "jax":
                        jpipe.prepare_chunk_plan(io.BytesIO(bytes(raw)), cc, jcol)
                    else:
                        tpipe.prepare_chunk_plan(io.BytesIO(bytes(raw)), cc, tcol)
                    result = "recovered"
                except ValueError as e:  # both packages' typed errors
                    result = type(e).__name__
        if pkg == "jax":
            recovered = tr.stages.get("prepare_fallback_recovered")
            counts = {"recovered": recovered.calls if recovered else 0}
        else:
            counts = {"recovered": tpipe.prepare_counts().get("prepare_fallback_recovered", 0)}
        outcomes.append((fault.code, fault.stage, fault.page, fault.offset, result, counts))
    assert outcomes[0] == outcomes[1], (ctx, outcomes)
    return outcomes[1]


def test_corrupt_page_header_same_stage_and_error(tmp_path):
    raw, off, _payload = _corrupt_file(tmp_path)
    raw[off] = 0xFF  # the first page header's first field byte
    code, stage, page, _o, result, counts = _ladder(raw, "header")
    assert (code, stage, page) == (tnative.PREPARE_E_CORRUPT, "header", 0)
    assert result != "recovered" and counts["recovered"] == 0


def test_corrupt_snappy_block_same_stage_and_error(tmp_path):
    raw, _off, payload = _corrupt_file(tmp_path)
    raw[payload : payload + 8] = b"\xff" * 8  # the snappy preamble and tags
    code, stage, page, _o, result, counts = _ladder(raw, "snappy")
    assert (code, stage, page) == (tnative.PREPARE_E_CORRUPT, "decompress", 0)
    assert result == "CompressionError"


def test_fault_counters_and_recovery(tmp_path, monkeypatch):
    # a walk that aborts on a chunk the staged walk reads cleanly: the
    # level-capacity fault of a metadata value count that understates
    path = _build(tmp_path, "plain_i64", "snappy", "1.0")
    raw = path.read_bytes()
    real = tnative.NativeLib.chunk_prepare

    def lying(self, data, codec, max_def, max_rep, type_size, nbits, expected, cap, **kw):
        return real(self, data, codec, max_def, max_rep, type_size, nbits, 0, cap, **kw)

    monkeypatch.setattr(tnative.NativeLib, "chunk_prepare", lying)
    tpipe.reset_prepare_counts()
    n = 0
    for cc, _jcol, tcol in _chunks(raw):
        plan = tpipe.prepare_chunk_plan(io.BytesIO(raw), cc, tcol)
        assert plan.native_def is None and plan.plain_host is not None
        n += 1
    counts = tpipe.prepare_counts()
    assert counts == {
        "prepare_fused_declined": n,
        "prepare_fused_fault_levels": n,
        "prepare_fallback_recovered": n,
    }, counts


@pytest.mark.parametrize("size", [0, 1, 63, 4096, 300_000])
def test_codecs_round_trip_against_reference(size):
    rng = np.random.default_rng(size)
    data = (rng.integers(0, 7, size, dtype=np.uint8) * 3).tobytes()
    jlib = j_native()
    for codec in (CompressionCodec.SNAPPY, CompressionCodec.LZ4_RAW, CompressionCodec.LZ4):
        t_enc = tcompress.compress_block(data, codec)
        j_enc = jcompress.compress_block(data, codec)
        assert t_enc == j_enc, codec  # the same encoder: the same bytes
        assert bytes(jcompress.decompress_block(t_enc, codec, size)) == data
        assert bytes(tcompress.decompress_block(j_enc, codec, size)) == data
    assert tnative.get_native().snappy_compress(data) == jlib.snappy_compress(data)
    assert tnative.get_native().lz4_compress(data) == jlib.lz4_compress(data)


def test_corrupt_codec_input_raises_typed_error():
    for codec in (CompressionCodec.SNAPPY, CompressionCodec.LZ4_RAW, CompressionCodec.LZ4):
        with pytest.raises(tcompress.CompressionError):
            tcompress.decompress_block(b"\xff" * 32, codec, 100)


def test_reader_engages_fused_walk_on_every_chunk(tmp_path):
    path = _build(tmp_path, "dict_str", "snappy", "2.0")
    tpipe.reset_prepare_counts()
    with FileReader(path, backend="device_roundtrip", device="cpu") as r:
        groups = [r.read_row_group(i) for i in range(r.num_row_groups)]
    with JReader(str(path)) as jr:
        for i, g in enumerate(groups):
            ref = jr.read_row_group(i)
            for p, cd in g.items():
                assert _same(cd.values, ref[p].values)
    assert tpipe.prepare_counts() == {"prepare_fused_engaged": len(groups)}


def test_host_library_is_the_ports_own_build():
    from parquet_tpu_torch.kernels import host_build
    from parquet_tpu_torch.kernels.build import BUILD_ROOT

    lib_path = tnative.get_native()._lib._name
    assert lib_path.startswith(str(BUILD_ROOT / "host-")), lib_path
    assert lib_path.endswith(host_build.LIB_NAME) and "native/build" not in lib_path


def test_host_build_failures_raise_typed_errors(monkeypatch, tmp_path):
    from parquet_tpu_torch.kernels import host_build

    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(host_build.HostBuildError, match="compiler"):
        host_build._cxx()
    monkeypatch.undo()
    broken = tmp_path / "src"
    broken.mkdir()
    (broken / "prepare.cc").write_text("this is not C++\n")
    (broken / "prepare.h").write_text("")
    monkeypatch.setattr(host_build, "NATIVE", broken)
    out = tmp_path / "out"
    out.mkdir()
    with pytest.raises(host_build.HostBuildError, match="build failed"):
        host_build._build(out)
    assert not (out / host_build.LIB_NAME).exists()
