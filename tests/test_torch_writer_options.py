"""The port's FileWriter options against the JAX package's, byte for byte.

Both packages write the same seeded NumPy columns (required and optional
numerics, a DELTA column, a boolean RLE column, byte arrays, FLBA, a LIST)
and every file must be identical, over codec (uncompressed, snappy, gzip) x
data page V1/V2 x dictionary on/off x PQT_FUSED_ENCODE 0/1, each cell with
bloom_filters= (True, a list, a dict with fpp/ndv), write_page_index=,
parallel=True and parallel=2, alone and together. The fused encode walk's
counts (write_counts()) follow the reference's ladder: engaged on flat
chunks without a page index, declined with one, silent under
PQT_FUSED_ENCODE=0. Also: a deferred parallel fault surfaces as WriterError
with no committed file; write_device_column with bloom_filters= on CPU
tensors equals the host write; under write_page_index= the device column
declines, counted, to the same bytes.
"""

import io
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import parquet_tpu.kernels.device_ops  # noqa: E402,F401  (turns x64 on first)
from parquet_tpu.core.writer import FileWriter as JWriter  # noqa: E402
from parquet_tpu.schema.dsl import parse_schema as j_parse_schema  # noqa: E402
from parquet_tpu.sink import MemorySink as JMemorySink  # noqa: E402

import parquet_tpu_torch  # noqa: E402
from parquet_tpu_torch import FileWriter, WriterError, parse_schema  # noqa: E402
from parquet_tpu_torch.core import compress as tcompress  # noqa: E402
from parquet_tpu_torch.core.chunk import chunk_byte_range  # noqa: E402
from parquet_tpu_torch.sink import BufferedSink, MemorySink  # noqa: E402
from parquet_tpu_torch.sink import encoder as tencoder  # noqa: E402

DSL = """message m {
  required int64 id;
  optional int32 v;
  required int64 seq;
  required double x;
  required boolean flag;
  optional binary s (STRING);
  required fixed_len_byte_array(5) f;
  optional group tags (LIST) { repeated group list { required int32 element; } }
}"""
N, GROUPS = 1500, 3
FLAT_LEAVES = 7  # every leaf but the LIST element


def _groups(seed: int = 29):
    rng = np.random.default_rng(seed)
    out = []
    for g in range(GROUPS):
        valid = rng.random(N) >= 0.1
        s_valid = rng.random(N) >= 0.05
        lens = rng.integers(0, 4, N)
        list_valid = rng.random(N) >= 0.1
        lens[~list_valid] = 0
        # Dremel levels of the LIST: def 0 null list, 1 empty list, 2 element
        dls, rls = [], []
        for ok, n in zip(list_valid, lens):
            if not ok:
                dls.append(0)
                rls.append(0)
            elif n == 0:
                dls.append(1)
                rls.append(0)
            else:
                dls += [2] * n
                rls += [0] + [1] * (n - 1)
        out.append({
            "id": (rng.integers(0, 40, N) + g * 1000).astype(np.int64),
            "v": (rng.integers(-9, 9, int(valid.sum())).astype(np.int32),
                  valid.astype(np.uint16)),
            "seq": np.cumsum(rng.integers(-3, 90, N)).astype(np.int64) + g,
            "x": np.round(rng.normal(size=N), 2),
            "flag": rng.random(N) > 0.7,
            "s": (np.array([f"s{int(k)}".encode() for k in rng.integers(0, 300, int(s_valid.sum()))],
                           dtype=object), s_valid.astype(np.uint16)),
            "f": rng.integers(0, 256, (N, 5), dtype=np.uint8),
            "tags": (rng.integers(0, 1000, int(lens.sum())).astype(np.int32),
                     np.array(dls, np.uint16), np.array(rls, np.uint16)),
        })
    return out


GROUPS_DATA = _groups()
ENCODINGS = {"seq": "DELTA_BINARY_PACKED", "flag": "RLE"}


def _write(W, sink, schema, **opts):
    w = W(sink, schema, column_encodings=ENCODINGS, **opts)
    for grp in GROUPS_DATA:
        for leaf, v in grp.items():
            if leaf == "tags":
                w.write_column("tags.list.element", v[0], def_levels=v[1], rep_levels=v[2])
            elif isinstance(v, tuple):
                w.write_column(leaf, v[0], def_levels=v[1])
            else:
                w.write_column(leaf, v)
        w.flush_row_group()
    w.close()
    return sink.getvalue()


def _both(**opts):
    jraw = _write(JWriter, JMemorySink(), j_parse_schema(DSL), **opts)
    parquet_tpu_torch.reset_write_counts()
    traw = _write(FileWriter, MemorySink(), parse_schema(DSL), **opts)
    return jraw, traw, parquet_tpu_torch.write_counts()


OPTION_SETS = {
    "plain": {},
    "bloom_true": {"bloom_filters": True},
    "bloom_list": {"bloom_filters": ["id", "s", "f"]},
    "bloom_dict_index": {"bloom_filters": {"x": {"fpp": 0.05}, "seq": {"ndv": 100, "fpp": 0.2},
                                           "s": True},
                         "write_page_index": True},
    "index_parallel": {"write_page_index": True, "parallel": True},
    "parallel2_bloom": {"parallel": 2, "bloom_filters": True, "max_inflight_bytes": 1},
}


@pytest.mark.parametrize("fused", ["0", "1"])
@pytest.mark.parametrize("use_dict", [True, False])
@pytest.mark.parametrize("dpv", [1, 2])
@pytest.mark.parametrize("codec", ["uncompressed", "snappy", "gzip"])
def test_writer_options_match_jax(monkeypatch, codec, dpv, use_dict, fused):
    monkeypatch.setenv("PQT_FUSED_ENCODE", fused)
    for label, opts in OPTION_SETS.items():
        jraw, traw, counts = _both(codec=codec, data_page_version=dpv,
                                   use_dictionary=use_dict, **opts)
        assert traw == jraw, label
        chunks = GROUPS * (FLAT_LEAVES + 1)
        if fused == "0":
            assert counts["encode_fused_engaged"] == counts["encode_fused_declined"] == 0, label
        elif opts.get("write_page_index"):
            assert counts["encode_fused_declined"] == chunks, label
            assert counts["encode_fused_engaged"] == 0, label
        else:
            # every flat chunk engages (the boolean is RLE, a fused route);
            # the LIST (max_rep > 0) declines
            assert counts["encode_fused_engaged"] == GROUPS * FLAT_LEAVES, label
            assert counts["encode_fused_declined"] == GROUPS, label
        assert counts["encode_fallback_recovered"] == 0, label


def test_page_index_and_blooms_land_between_the_groups_and_the_footer():
    jraw, traw, _ = _both(codec="snappy", write_page_index=True, bloom_filters=True)
    assert traw == jraw
    meta = parquet_tpu_torch.read_file_metadata(io.BytesIO(traw))
    last_page_end = max(sum(chunk_byte_range(cc)) for rg in meta.row_groups for cc in rg.columns)
    for rg in meta.row_groups:
        for cc in rg.columns:
            assert cc.column_index_offset >= last_page_end
            assert cc.offset_index_offset > cc.column_index_offset
            if cc.meta_data.type != 0:  # BOOLEAN takes no bloom filter
                assert last_page_end <= cc.meta_data.bloom_filter_offset < cc.column_index_offset


def test_bloom_filters_refuse_booleans_like_jax():
    with pytest.raises(WriterError) as t_err:
        FileWriter(MemorySink(), parse_schema(DSL), bloom_filters=["flag"])
    from parquet_tpu.core.writer import WriterError as JWriterError

    with pytest.raises(JWriterError) as j_err:
        JWriter(JMemorySink(), j_parse_schema(DSL), bloom_filters=["flag"])
    assert str(t_err.value) == str(j_err.value)
    with pytest.raises(WriterError, match="positive worker count"):
        FileWriter(MemorySink(), parse_schema(DSL), parallel=-1)


def test_buffered_sink_writes_the_same_bytes():
    inner = MemorySink()
    sink = BufferedSink(inner, spill_bytes=4096)
    w = FileWriter(sink, parse_schema(DSL), codec="snappy", bloom_filters=True)
    for leaf, v in GROUPS_DATA[0].items():
        if leaf == "tags":
            w.write_column("tags.list.element", v[0], def_levels=v[1], rep_levels=v[2])
        elif isinstance(v, tuple):
            w.write_column(leaf, v[0], def_levels=v[1])
        else:
            w.write_column(leaf, v)
    w.close()
    sink.close()
    ref = MemorySink()
    w = FileWriter(ref, parse_schema(DSL), codec="snappy", bloom_filters=True)
    for leaf, v in GROUPS_DATA[0].items():
        if leaf == "tags":
            w.write_column("tags.list.element", v[0], def_levels=v[1], rep_levels=v[2])
        elif isinstance(v, tuple):
            w.write_column(leaf, v[0], def_levels=v[1])
        else:
            w.write_column(leaf, v)
    w.close()
    assert inner.getvalue() == ref.getvalue()
    assert sink.buffered() == 0


def test_buffered_sink_matches_jax_semantics():
    from parquet_tpu.sink import BufferedSink as JBufferedSink
    from parquet_tpu.sink import SinkError as JSinkError

    from parquet_tpu_torch.sink import SinkError

    for B, M, Err in ((BufferedSink, MemorySink, SinkError),
                      (JBufferedSink, JMemorySink, JSinkError)):
        inner = M()
        s = B(inner, spill_bytes=10)
        s.write(b"abc")
        assert (s.buffered(), s.tell(), inner.getvalue()) == (3, 3, b"")
        s.write(b"0123456789")
        assert (s.buffered(), s.tell(), inner.getvalue()) == (0, 13, b"abc0123456789")
        s.write(b"z")
        s.close()
        assert inner.getvalue() == b"abc0123456789z"
        with pytest.raises(Err, match="closed"):
            s.write(b"late")
        with pytest.raises(ValueError, match="spill_bytes"):
            B(M(), spill_bytes=0)


class _FailingSink(MemorySink):
    """A sink whose writes fail once `limit` bytes have gone through."""

    def __init__(self, limit: int):
        super().__init__()
        self.limit = limit
        self.seen = 0

    def write(self, data):
        self.seen += len(data)
        if self.seen > self.limit:
            raise OSError("disk full (test)")
        return super().write(data)


def test_parallel_deferred_sink_fault_is_typed(tmp_path):
    path = tmp_path / "f.parquet"
    w = FileWriter(path, parse_schema("message m { required int64 id; }"), parallel=2)
    w._pipeline.sink = _FailingSink(100)  # the flusher's writes fail
    with pytest.raises(WriterError, match="background encode/flush failed"):
        for g in range(50):
            w.write_column("id", np.arange(1000, dtype=np.int64) + g)
            w.flush_row_group()
        w.close()
    assert w.close() is None  # idempotent after the error
    assert not path.exists()
    assert not list(tmp_path.iterdir())


def test_parallel_deferred_encode_fault_never_commits(tmp_path):
    path = tmp_path / "f.parquet"
    schema = parse_schema("message m { required int64 id; required double x; }")
    w = FileWriter(path, schema, parallel=True)
    w.write_column("id", np.arange(10, dtype=np.int64))
    w.write_column("x", np.zeros(10))
    w.flush_row_group()
    w.write_column("id", np.array(["not", "an", "int"], dtype=object))  # fails at encode
    w.write_column("x", np.zeros(3))
    w.flush_row_group()  # returns: the fault is on the pool
    with pytest.raises(WriterError, match="background encode/flush failed"):
        w.close()
    assert w.close() is None
    assert not path.exists()
    assert not list(tmp_path.iterdir())
    for t in threading.enumerate():
        assert not t.name.startswith("pqt-flush") or not t.is_alive()


def _device_schemas(dsl):
    return j_parse_schema(dsl), parse_schema(dsl)


def _dev_groups(seed=31):
    rng = np.random.default_rng(seed)
    out = []
    for g in range(2):
        words = [f"zone-{int(k)}".encode() for k in rng.integers(0, 500, 2000)]
        data = np.frombuffer(b"".join(words), np.uint8)
        offsets = np.concatenate([[0], np.cumsum([len(w) for w in words])]).astype(np.int64)
        out.append({
            "id": np.arange(2000, dtype=np.int64) + 10**9 + g * 2000,
            "vendor": rng.integers(1, 9, 2000).astype(np.int32),
            "pickup": np.cumsum(rng.integers(-5, 900, 2000)).astype(np.int64),
            "dist": np.round(rng.gamma(1.5, 2.5, 2000), 2),
            "zone": (words, data, offsets),
        })
    return out


DEV_DSL = """message t { required int64 id; required int32 vendor; required int64 pickup;
  required double dist; required binary zone (STRING); }"""


def _device_write(device: bool, **opts):
    sink = MemorySink()
    parquet_tpu_torch.reset_write_counts()
    with FileWriter(sink, parse_schema(DEV_DSL), codec="snappy",
                    use_dictionary=["id", "vendor", "dist"],
                    column_encodings={"pickup": "DELTA_BINARY_PACKED"}, **opts) as w:
        for grp in _dev_groups():
            for leaf, v in grp.items():
                if leaf == "zone":
                    if device:
                        w.write_device_column(leaf, (torch.from_numpy(v[1].copy()),
                                                     torch.from_numpy(v[2])))
                    else:
                        w.write_column(leaf, np.array(v[0], dtype=object))
                elif device:
                    w.write_device_column(leaf, torch.from_numpy(v.copy()))
                else:
                    w.write_column(leaf, v)
            w.flush_row_group()
    return sink.getvalue(), parquet_tpu_torch.write_counts()


def _jax_write(**opts):
    sink = JMemorySink()
    with JWriter(sink, j_parse_schema(DEV_DSL), codec="snappy",
                 use_dictionary=["id", "vendor", "dist"],
                 column_encodings={"pickup": "DELTA_BINARY_PACKED"}, **opts) as w:
        for grp in _dev_groups():
            for leaf, v in grp.items():
                w.write_column(leaf, np.array(v[0], dtype=object) if leaf == "zone" else v)
            w.flush_row_group()
    return sink.getvalue()


@pytest.mark.parametrize("blooms", [True, ["id", "pickup", "dist", "zone"],
                                    {"vendor": {"fpp": 0.1}, "pickup": {"ndv": 64}}])
def test_device_write_with_blooms_equals_the_host_write(blooms):
    dev, dc = _device_write(True, bloom_filters=blooms)
    host, _ = _device_write(False, bloom_filters=blooms)
    assert dev == host == _jax_write(bloom_filters=blooms)
    assert (dc["device_write_engaged"], dc["device_write_declined"]) == (10, 0)


def test_device_write_under_the_page_index_declines_counted():
    dev, dc = _device_write(True, write_page_index=True, bloom_filters=True)
    host, _ = _device_write(False, write_page_index=True, bloom_filters=True)
    assert dev == host == _jax_write(write_page_index=True, bloom_filters=True)
    assert (dc["device_write_engaged"], dc["device_write_declined"]) == (0, 10)


def test_fused_gzip_probe_and_codec_gate():
    assert tcompress.fused_gzip_identical() is True
    for codec in (0, 1, 2):
        assert tcompress.is_fused_encode_codec(codec)
    assert not tcompress.is_fused_encode_codec(7)  # LZ4_RAW: staged only


def test_codec_override_declines_the_fused_walk(monkeypatch):
    class Copy:
        def compress(self, data):
            return bytes(data)

        def decompress(self, data, n):
            return bytes(data)

    monkeypatch.setitem(tcompress._REGISTRY, 0, Copy())
    parquet_tpu_torch.reset_write_counts()
    sink = MemorySink()
    with FileWriter(sink, parse_schema("message m { required int64 a; }")) as w:
        w.write_column("a", np.arange(100, dtype=np.int64))
    c = parquet_tpu_torch.write_counts()
    assert (c["encode_fused_engaged"], c["encode_fused_declined"]) == (0, 1)


def test_encode_fault_is_recovered_by_the_staged_rung(monkeypatch):
    """A native refusal (an EncodeFault) falls to the staged encoder,
    counted as a fault of its stage and a recovery, with the same bytes."""
    from parquet_tpu_torch.utils import native as tnative

    schema = parse_schema("message m { required int64 a; }")
    vals = np.arange(5000, dtype=np.int64) * 3

    def write():
        sink = MemorySink()
        with FileWriter(sink, schema, codec="gzip", use_dictionary=False) as w:
            w.write_column("a", vals)
        return sink.getvalue()

    want = write()
    lib = tnative.get_native()
    monkeypatch.setattr(type(lib), "chunk_encode",
                        lambda self, *a, **k: tnative.EncodeFault(-5, "compress", 0))
    parquet_tpu_torch.reset_write_counts()
    assert write() == want
    c = parquet_tpu_torch.write_counts()
    assert c["encode_fused_fault_compress"] == 1
    assert c["encode_fallback_recovered"] == 1
    assert c["encode_fused_declined"] == 1 and c["encode_fused_engaged"] == 0
    parquet_tpu_torch.reset_write_counts()
    assert "encode_fused_fault_compress" not in parquet_tpu_torch.write_counts()


def test_encode_pool_is_the_writers_own():
    pool = tencoder.encode_pool()
    assert pool is tencoder.encode_pool()
    assert pool.submit(lambda: threading.current_thread().name).result(timeout=30) \
        .startswith("pqt-encode")
    assert pool._max_workers == min(os.cpu_count() or 1, 8)


# -- the fused walk against its oracle, the staged rung --------------------------


def _builder(schema, leaf, values, def_levels=None, use_dict=True):
    from parquet_tpu_torch.core.column_store import ColumnChunkBuilder

    b = ColumnChunkBuilder(schema.column(leaf), use_dict)
    b.set_columnar(values, def_levels)
    return b


def _walk_cases():
    rng = np.random.default_rng(37)
    n = 20_000
    valid = rng.random(n) > 0.25
    schema = parse_schema("""message w { required int64 a; required float f;
      optional int32 o; required binary s; optional binary os; required fixed_len_byte_array(3) q;
      required boolean b; required int32 d; required int64 dd; }""")
    words = np.array([f"w{int(k)}".encode() * int(k % 5) for k in rng.integers(0, 9000, n)],
                     dtype=object)
    return schema, {
        "plain_int64": ("a", rng.integers(-(1 << 60), 1 << 60, n), None, {}, False),
        "dict_int64": ("a", rng.integers(0, 300, n), None, {}, True),
        "plain_float": ("f", rng.normal(size=n).astype(np.float32), None, {}, False),
        "optional_int32": ("o", rng.integers(0, 1 << 20, int(valid.sum())).astype(np.int32),
                           valid.astype(np.uint16), {}, False),
        "optional_dict": ("o", rng.integers(0, 7, int(valid.sum())).astype(np.int32),
                          valid.astype(np.uint16), {}, True),
        "all_null": ("o", np.zeros(0, np.int32), np.zeros(n, np.uint16), {}, False),
        "bytes": ("s", words, None, {}, False),
        "bytes_dict": ("s", words[:5000].copy(), None, {}, True),
        "optional_bytes": ("os", words[: int(valid.sum())].copy(), valid.astype(np.uint16), {},
                           False),
        "flba": ("q", rng.integers(0, 256, (n, 3), dtype=np.uint8), None, {}, False),
        "bool_rle": ("b", rng.random(n) > 0.9, None, {"b": "RLE"}, False),
        "delta32": ("d", np.cumsum(rng.integers(-9, 99, n)).astype(np.int32), None,
                    {"d": "DELTA_BINARY_PACKED"}, False),
        "delta64": ("dd", rng.integers(-(1 << 62), 1 << 62, n), None,
                    {"dd": "DELTA_BINARY_PACKED"}, False),
        "empty": ("a", np.zeros(0, np.int64), None, {}, False),
    }


WALK_SCHEMA, WALK_CASES = _walk_cases()


@pytest.mark.parametrize("with_crc", [False, True])
@pytest.mark.parametrize("dpv", [1, 2])
@pytest.mark.parametrize("codec", [0, 1, 2])
@pytest.mark.parametrize("case", sorted(WALK_CASES))
def test_chunk_encode_matches_the_staged_rung(case, codec, dpv, with_crc):
    from parquet_tpu_torch.meta.parquet_types import Encoding

    leaf, values, defs, encs, use_dict = WALK_CASES[case]
    cfg = tencoder.EncoderConfig(
        codec=codec, data_page_version=dpv, max_page_size=8192, with_crc=with_crc,
        column_encodings={(k,): Encoding[v] for k, v in encs.items()})
    plan = tencoder._plan_chunk(cfg, _builder(WALK_SCHEMA, leaf, values, defs, use_dict))
    parquet_tpu_torch.reset_write_counts()
    fused = tencoder._fused_encode_chunk(
        cfg, _builder(WALK_SCHEMA, leaf, values, defs, use_dict), None, plan)
    assert isinstance(fused, tencoder.EncodedChunk), fused
    assert parquet_tpu_torch.write_counts()["encode_fused_engaged"] == 1
    staged = tencoder._staged_encode_chunk(
        cfg, _builder(WALK_SCHEMA, leaf, values, defs, use_dict), None, plan)
    assert b"".join(bytes(p) for p in fused.parts) == b"".join(bytes(p) for p in staged.parts)
    assert fused.nbytes == staged.nbytes
    assert fused.chunk.dumps() == staged.chunk.dumps()


def test_gzip_compress_matches_zlib():
    import zlib

    from parquet_tpu_torch.utils.native import get_native

    rng = np.random.default_rng(43)
    for data in (b"", b"a", bytes(range(256)) * 40, rng.integers(0, 256, 100_000,
                                                                 dtype=np.uint8).tobytes()):
        c = zlib.compressobj(wbits=31)
        assert get_native().gzip_compress(data) == c.compress(data) + c.flush()
