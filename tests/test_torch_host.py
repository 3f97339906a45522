"""The port's copied host modules against the JAX package's, on the same bytes.

Footer metadata, the hybrid and delta prescan tables, dictionary pages, the
host chunk decode, and the encoders the port's synth writer uses: each must
give exactly what the JAX package gives. The JAX side may use its native
helpers; the port runs its NumPy paths.
"""

import io
import threading
from pathlib import Path

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

pytest.importorskip("torch")

import parquet_tpu.kernels.device_ops  # noqa: E402,F401  (turns x64 on first)
from parquet_tpu.core import chunk as jchunk  # noqa: E402
from parquet_tpu.core import page as jpage  # noqa: E402
from parquet_tpu.core.reader import FileReader as JReader  # noqa: E402
from parquet_tpu.meta.file_meta import read_file_metadata as j_read_meta  # noqa: E402
from parquet_tpu.ops import delta as jdelta  # noqa: E402
from parquet_tpu.ops import rle_hybrid as jhybrid  # noqa: E402

from parquet_tpu_torch.core import chunk as tchunk  # noqa: E402
from parquet_tpu_torch.core import page as tpage  # noqa: E402
from parquet_tpu_torch.core.arrays import ByteArrayData  # noqa: E402
from parquet_tpu_torch.core.compress import CompressionError  # noqa: E402
from parquet_tpu_torch.core.schema import Schema  # noqa: E402
from parquet_tpu_torch.meta.file_meta import read_file_metadata as t_read_meta  # noqa: E402
from parquet_tpu_torch.meta.parquet_types import CompressionCodec  # noqa: E402
from parquet_tpu_torch.ops import delta as tdelta  # noqa: E402
from parquet_tpu_torch.ops import rle_hybrid as thybrid  # noqa: E402

GOLDEN = Path(__file__).parent / "golden" / "data"
GOLDEN_FILES = sorted(p.name for p in GOLDEN.glob("*.parquet"))
# the golden files whose codecs the port reads (UNCOMPRESSED / GZIP)
READABLE = {
    "alltypes_plain_v1_none.parquet",
    "alltypes_v2_gzip.parquet",
    "delta_byte_array.parquet",
    "kv_metadata_and_empty_tail.parquet",
    "nulls_heavy.parquet",
    "foreign_bool_rle_shapes.parquet",
    "foreign_zero_row.parquet",
}


def _same(a, b):
    """Exact equality of decoded buffers (floats by bit pattern)."""
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


def assert_chunk_equal(port, ref):
    assert port.num_values == ref.num_values
    for f in ("values", "def_levels", "rep_levels", "dictionary"):
        assert _same(getattr(port, f), getattr(ref, f)), f


def _pyarrow_file(tmp_path, compression, version):
    rng = np.random.default_rng(3)
    n = 6000
    t = pa.table(
        {
            "i64": pa.array(rng.integers(-(2**60), 2**60, n), pa.int64()),
            "d32": pa.array(rng.integers(0, 50, n).astype(np.int32)),
            "s": pa.array([f"k{i % 700}" for i in range(n)]),
            "opt": pa.array([None if i % 7 == 0 else float(i % 13) for i in range(n)]),
            "lst": pa.array([[j for j in range(i % 4)] for i in range(n)], pa.list_(pa.int32())),
            "delta": pa.array(np.cumsum(rng.integers(-5, 50, n)).astype(np.int64)),
        }
    )
    path = tmp_path / f"f_{compression}_{version}.parquet"
    pq.write_table(
        t, path, compression=compression, data_page_version=version,
        use_dictionary=["d32", "s", "opt"], column_encoding={"delta": "DELTA_BINARY_PACKED"},
        data_page_size=4096, row_group_size=2500,
    )
    return path


@pytest.mark.parametrize("name", GOLDEN_FILES)
def test_footer_metadata_matches(name):
    raw = (GOLDEN / name).read_bytes()
    port = t_read_meta(io.BytesIO(raw))
    ref = j_read_meta(io.BytesIO(raw))
    assert port.dumps() == ref.dumps()


@pytest.mark.parametrize("width", [0, 1, 2, 5, 8, 13, 20, 31, 32])
def test_prescan_hybrid_tables_match(width):
    rng = np.random.default_rng(width)
    v = rng.integers(0, 1 << width, size=5000, dtype=np.uint64) if width else np.zeros(5000, np.uint64)
    v[100:400] = v[100]
    v[2000:2009] = v[2000]
    stream = jhybrid.encode_hybrid(v, width)
    assert thybrid.encode_hybrid(v, width) == stream
    p = thybrid.prescan_hybrid(stream, len(v), width)
    r = jhybrid.prescan_hybrid(stream, len(v), width)
    for f in ("is_rle", "counts", "rle_values", "bp_offsets"):
        np.testing.assert_array_equal(getattr(p, f), getattr(r, f), err_msg=f)
    assert bytes(p.packed) == bytes(r.packed)
    np.testing.assert_array_equal(
        thybrid.decode_hybrid(stream, len(v), width), jhybrid.decode_hybrid(stream, len(v), width)
    )


@pytest.mark.parametrize("nbits", [32, 64])
def test_prescan_delta_tables_match(nbits):
    rng = np.random.default_rng(nbits)
    dt = np.int32 if nbits == 32 else np.int64
    info = np.iinfo(dt)
    v = np.concatenate(
        [
            rng.integers(info.min, info.max, 700, dtype=dt, endpoint=True),
            np.cumsum(rng.integers(-9, 90, 900)).astype(dt),
        ]
    )
    stream = jdelta.encode_delta(v, nbits)
    assert tdelta.encode_delta(v, nbits) == stream
    p = tdelta.prescan_delta_packed(stream, nbits, max_total=len(v))
    r = jdelta.prescan_delta_packed(stream, nbits, max_total=len(v))
    for f in ("widths", "byte_starts", "out_starts", "mins"):
        np.testing.assert_array_equal(getattr(p, f), getattr(r, f), err_msg=f)
    assert (p.first_value, p.total, p.consumed) == (r.first_value, r.total, r.consumed)
    np.testing.assert_array_equal(tdelta.decode_delta(stream, nbits)[0], v)


def _golden_or_pyarrow(tmp_path):
    files = [GOLDEN / n for n in sorted(READABLE)]
    for comp in ("NONE", "GZIP"):
        for ver in ("1.0", "2.0"):
            files.append(_pyarrow_file(tmp_path, comp, ver))
    return files


def _chunks(path):
    raw = Path(path).read_bytes()
    meta = t_read_meta(io.BytesIO(raw))
    schema = Schema.from_thrift(meta.schema)
    for rg in meta.row_groups or []:
        for cc in rg.columns:
            yield raw, cc, schema.column(tuple(cc.meta_data.path_in_schema))


def test_dictionary_pages_decode_equal(tmp_path):
    from parquet_tpu.core.schema import Schema as JSchema

    seen = 0
    for path in _golden_or_pyarrow(tmp_path):
        jmeta = j_read_meta(io.BytesIO(Path(path).read_bytes()))
        jschema = JSchema.from_thrift(jmeta.schema)
        for raw, cc, col in _chunks(path):
            jcol = jschema.column(col.path)
            for page in tchunk.iter_chunk_pages(io.BytesIO(raw), cc):
                if page.header.type != 2:
                    continue
                from parquet_tpu_torch.core.compress import decompress_block

                block = decompress_block(
                    page.payload, cc.meta_data.codec or 0, page.header.uncompressed_page_size
                )
                assert _same(
                    tpage.decode_dict_page(page.header, block, col),
                    jpage.decode_dict_page(page.header, block, jcol),
                )
                seen += 1
    assert seen >= 10


def test_host_read_chunk_matches(tmp_path):
    n = 0
    for path in _golden_or_pyarrow(tmp_path):
        with JReader(str(path)) as jr:
            for i in range(jr.num_row_groups):
                for cc in jr.row_group(i).columns:
                    p = tuple(cc.meta_data.path_in_schema)
                    ref = jchunk.read_chunk(jr._f, cc, jr.schema.column(p))
                    raw = Path(path).read_bytes()
                    schema = Schema.from_thrift(t_read_meta(io.BytesIO(raw)).schema)
                    port = tchunk.read_chunk(io.BytesIO(raw), cc, schema.column(p))
                    assert_chunk_equal(port, ref)
                    n += 1
    assert n > 40


class _Zstd:
    """A ZSTD codec over the zstandard module, registered by tests only (the
    port builds in no ZSTD). A
    zstandard (de)compressor object is not thread-safe and the reader's
    prepare pool runs a codec from several threads, so each thread keeps
    its own."""

    name = "ZSTD"

    def __init__(self):
        self._tl = threading.local()

    def _get(self):
        import zstandard

        tl = self._tl
        if not hasattr(tl, "d"):
            tl.c = zstandard.ZstdCompressor()
            tl.d = zstandard.ZstdDecompressor()
        return tl

    def compress(self, data):
        return self._get().c.compress(bytes(data))

    def decompress(self, data, uncompressed_size):
        return self._get().d.decompress(bytes(data), max_output_size=max(uncompressed_size, 1))


@pytest.mark.parametrize("name", sorted(set(GOLDEN_FILES) - READABLE))
def test_other_codecs_raise_typed_error(name, monkeypatch):
    # The golden files beyond UNCOMPRESSED/GZIP. With their codec registered
    # (SNAPPY is built in; ZSTD through a codec this test registers) every
    # chunk decodes equal to the reference; with it unregistered, every
    # compressed chunk raises the typed "not registered" error.
    from parquet_tpu_torch.core import compress as tcompress

    raw = (GOLDEN / name).read_bytes()
    meta = t_read_meta(io.BytesIO(raw))
    schema = Schema.from_thrift(meta.schema)
    monkeypatch.setitem(tcompress._REGISTRY, int(CompressionCodec.ZSTD), _Zstd())
    codecs = set()
    with JReader(io.BytesIO(raw)) as jr:
        for rg in meta.row_groups:
            for cc in rg.columns:
                p = tuple(cc.meta_data.path_in_schema)
                ref = jchunk.read_chunk(jr._f, cc, jr.schema.column(p))
                assert_chunk_equal(tchunk.read_chunk(io.BytesIO(raw), cc, schema.column(p)), ref)
                codecs.add(int(cc.meta_data.codec))
    for codec in codecs - {int(CompressionCodec.UNCOMPRESSED)}:
        monkeypatch.delitem(tcompress._REGISTRY, codec)
    raised = 0
    for rg in meta.row_groups:
        for cc in rg.columns:
            col = schema.column(tuple(cc.meta_data.path_in_schema))
            try:
                tchunk.read_chunk(io.BytesIO(raw), cc, col)
            except CompressionError as e:  # a V2 page stored uncompressed still reads
                assert "not registered" in str(e)
                raised += 1
    assert raised


def test_byte_array_take_and_from_list():
    b = ByteArrayData.from_list([b"a", b"", b"xyz", b"pq"])
    assert b.take(np.array([2, 0, 1, 2])).to_list() == [b"xyz", b"a", b"", b"xyz"]
    with pytest.raises(IndexError):
        b.take(np.array([4]))
