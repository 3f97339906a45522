"""The port's FileReader surface, its import hygiene and its synth writer."""

import ast
import io
import subprocess
import sys
from pathlib import Path

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

torch = pytest.importorskip("torch")

import parquet_tpu.kernels.device_ops  # noqa: E402,F401  (turns x64 on first)
from parquet_tpu.core.reader import FileReader as JReader  # noqa: E402

import parquet_tpu_torch  # noqa: E402
from parquet_tpu_torch import FileReader  # noqa: E402
from parquet_tpu_torch.core.arrays import ByteArrayData  # noqa: E402
from parquet_tpu_torch.core.compress import CompressionError  # noqa: E402
from parquet_tpu_torch.meta.parquet_types import CompressionCodec as C  # noqa: E402
from parquet_tpu_torch.meta.parquet_types import Encoding as E  # noqa: E402
from parquet_tpu_torch.meta.parquet_types import Type as T  # noqa: E402
from parquet_tpu_torch.testing.synth import ColumnSpec, column_values, write_file  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def small_file(tmp_path):
    t = pa.table({"a": pa.array(np.arange(100, dtype=np.int64)), "b": pa.array(["x", "y"] * 50)})
    path = tmp_path / "small.parquet"
    pq.write_table(t, path, compression="GZIP")
    return path


def test_no_cuda_and_no_device_raises(small_file, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        FileReader(small_file)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        FileReader(small_file, device="cuda")
    r = FileReader(small_file, device="cpu")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        r.read_row_group_device(0, device="cuda")
    r.close()


def test_sources_and_surface(small_file):
    raw = small_file.read_bytes()
    for src in (small_file, str(small_file), raw, io.BytesIO(raw)):
        with FileReader(src, device="cpu") as r:
            assert r.num_rows == 100 and r.num_row_groups == 1
            assert r.row_group(0).num_rows == 100
            assert set(r.read_row_group(0)) == {("a",), ("b",)}
    with FileReader(small_file, columns=["a"], device="cpu") as r:
        assert set(r.read_row_group_device(0)) == {("a",)}
        r.set_selected_columns("b")
        assert set(r.read_row_group(0)) == {("b",)}
        r.set_selected_columns()
        assert set(r.read_row_group(0)) == {("a",), ("b",)}
        with pytest.raises(IndexError):
            r.row_group(1)
    with pytest.raises(parquet_tpu_torch.ParquetFileError):
        FileReader(small_file, columns=["nope"], device="cpu")
    with pytest.raises(ValueError, match="backend"):
        FileReader(small_file, backend="tpu", device="cpu")
    with pytest.raises(parquet_tpu_torch.ParquetFileError):
        FileReader(b"not a parquet file at all", device="cpu")


def test_snappy_file_raises_typed_codec_error(tmp_path):
    # SNAPPY reads since the port carries its own codec; a corrupt snappy
    # block raises the typed CompressionError on every path (the fused walk
    # aborts at its decompress stage and the staged walk raises)
    from parquet_tpu_torch.core.chunk import iter_chunk_pages

    path = tmp_path / "s.parquet"
    pq.write_table(pa.table({"a": np.arange(50)}), path, compression="snappy")
    with FileReader(path, backend="device_roundtrip", device="cpu") as r:
        assert np.array_equal(r.read_row_group(0)[("a",)].values, np.arange(50))
    raw = bytearray(path.read_bytes())
    f = io.BytesIO(bytes(raw))
    with FileReader(path, device="cpu") as r:
        cc = r.row_group(0).columns[0]
    for page in iter_chunk_pages(f, cc):
        if page.header.data_page_header is not None:
            start = f.tell() - page.header.compressed_page_size
            break
    raw[start : start + 4] = b"\xff\xff\xff\x7f"  # the block's length preamble
    for backend in ("host", "device_roundtrip"):
        with FileReader(bytes(raw), backend=backend, device="cpu") as r:
            with pytest.raises(CompressionError, match="decompression failed"):
                r.read_row_group(0)
    with FileReader(bytes(raw), device="cpu") as r:
        with pytest.raises(parquet_tpu_torch.ParquetFileError, match="snappy"):
            r.read_row_groups_device()


def test_import_loads_no_jax_and_no_jax_package():
    code = (
        "import sys, parquet_tpu_torch, parquet_tpu_torch.testing.synth, "
        "parquet_tpu_torch.testing.parity, parquet_tpu_torch.kernels.build, "
        "parquet_tpu_torch.core.filter, parquet_tpu_torch.core.filter_vec, "
        "parquet_tpu_torch.core.filter_device, parquet_tpu_torch.core.stats, "
        "parquet_tpu_torch.core.bloom, parquet_tpu_torch.core.assembly, "
        "parquet_tpu_torch.floor.time, parquet_tpu_torch.ops.levels, "
        "parquet_tpu_torch.serve.server, parquet_tpu_torch.serve.session, "
        "parquet_tpu_torch.serve.executor, parquet_tpu_torch.serve.admission, "
        "parquet_tpu_torch.serve.counts, parquet_tpu_torch.obs.slo\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib'))"
        " or m == 'parquet_tpu' or m.startswith('parquet_tpu.'))\n"
        "print(bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, check=True
    )
    assert out.stdout.strip() == "[]"


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_source_scan_finds_no_jax_imports():
    files = sorted((REPO / "parquet_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "parquet_tpu"), f"{f}: imports {mod}"


def _synth_specs(n, seed=1):
    rng = np.random.default_rng(seed)
    valid = rng.random(n) > 0.1
    words = ByteArrayData.from_list([f"w{i}".encode() for i in range(300)])
    return [
        ColumnSpec("i64", T.INT64, values=rng.integers(-(2**60), 2**60, n)),
        ColumnSpec("d32", T.INT32, encoding=E.RLE_DICTIONARY, codec=C.GZIP, page_version=2,
                   dictionary=np.arange(50, dtype=np.int32) * 7, indices=rng.integers(0, 50, n).astype(np.int32)),
        ColumnSpec("opt", T.INT32, encoding=E.RLE_DICTIONARY, codec=C.GZIP, valid=valid,
                   dictionary=np.arange(5, dtype=np.int32), indices=rng.integers(0, 5, int(valid.sum())).astype(np.int32)),
        ColumnSpec("t64", T.INT64, encoding=E.DELTA_BINARY_PACKED, codec=C.GZIP, page_version=2,
                   values=np.cumsum(rng.integers(-10, 1000, n)).astype(np.int64)),
        ColumnSpec("f32", T.INT32, encoding=E.DELTA_BINARY_PACKED,
                   values=rng.integers(0, 10_000, n).astype(np.int32)),
        ColumnSpec("dbl", T.DOUBLE, encoding=E.RLE_DICTIONARY, codec=C.GZIP,
                   dictionary=rng.random(64), indices=rng.integers(0, 64, n).astype(np.int32)),
        ColumnSpec("s", T.BYTE_ARRAY, encoding=E.RLE_DICTIONARY, codec=C.GZIP, utf8=True,
                   dictionary=words, indices=rng.integers(0, 300, n).astype(np.int32)),
    ]


def test_synth_output_reads_back_in_pyarrow_and_jax(tmp_path):
    n = 7000
    specs = _synth_specs(n)
    path = tmp_path / "synth.parquet"
    write_file(path, specs, row_group_rows=3000, page_bytes=4096)
    table = pq.read_table(path)
    with JReader(str(path)) as jr:
        jgroups = [jr.read_row_group(i) for i in range(jr.num_row_groups)]
    assert len(jgroups) == 3
    for s in specs:
        want = column_values(s)
        col = table.column(s.name).combine_chunks()
        jvals = [g[(s.name,)].values for g in jgroups]
        if s.type == T.BYTE_ARRAY:
            assert col.to_pylist() == [b.decode() for b in want.to_list()]
            got = b"".join(bytes(v.data) for v in jvals)
            assert got == want.data
            continue
        if s.valid is not None:
            np.testing.assert_array_equal(~col.is_null().to_numpy(zero_copy_only=False), s.valid)
            col = col.drop_null()
            jdef = np.concatenate([g[(s.name,)].def_levels for g in jgroups])
            np.testing.assert_array_equal(jdef.astype(bool), s.valid)
        np.testing.assert_array_equal(col.to_numpy(), want)
        np.testing.assert_array_equal(np.concatenate(jvals), want)


def test_synth_pages_and_port_device_read(tmp_path):
    n = 7000
    specs = _synth_specs(n, seed=2)
    path = tmp_path / "synth.parquet"
    meta = write_file(path, specs, row_group_rows=3500, page_bytes=2048)
    md = pq.ParquetFile(path).metadata
    assert md.num_row_groups == 2 and meta.num_rows == n
    with FileReader(path, device="cpu") as r:
        groups = r.read_row_groups_device()
        assert r.stats.host_fallback_pages == 0 and r.stats.pages > 2 * len(specs)
    for s in specs:
        cols = [g[(s.name,)] for g in groups]
        if s.type == T.BYTE_ARRAY:
            idx = np.concatenate([c.indices.numpy() for c in cols])
            assert cols[0].dictionary.take(idx) == column_values(s)
            continue
        got = np.concatenate([c.values.numpy() for c in cols])
        np.testing.assert_array_equal(got, column_values(s))
