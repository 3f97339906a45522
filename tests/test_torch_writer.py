"""The port's FileWriter against the JAX package's, byte for byte.

Both packages write the same seeded NumPy values: the JAX FileWriter from
NumPy (write_column) and from jax arrays (write_device_column, on CPU jax),
the port's from NumPy and from CPU tensors (write_device_column: each
kernel's plain version runs). Every file must be identical byte for byte,
and the device columns must take the same route (engaged or declined, the
port's write_counts() against the JAX package's device_write_* events).
Schemas are built by the JAX package's DSL and handed to the port through
their Thrift form. The CUDA kernels run only on the card (chip_smoke.py).
"""

import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import parquet_tpu.kernels.device_ops  # noqa: E402,F401  (turns x64 on first)
from parquet_tpu.core.column_store import ColumnChunkBuilder as JBuilder  # noqa: E402
from parquet_tpu.core.writer import FileWriter as JWriter  # noqa: E402
from parquet_tpu.kernels.pipeline import encode_device_column as j_encode_device_column  # noqa: E402
from parquet_tpu.schema.dsl import parse_schema  # noqa: E402
from parquet_tpu.sink import MemorySink as JMemorySink  # noqa: E402
from parquet_tpu.sink.encoder import EncoderConfig as JEncoderConfig  # noqa: E402
from parquet_tpu.sink.encoder import encode_chunk as j_encode_chunk  # noqa: E402
from parquet_tpu.utils import metrics  # noqa: E402
from parquet_tpu.utils.native import get_native as j_get_native  # noqa: E402

import parquet_tpu_torch  # noqa: E402
from parquet_tpu_torch import FileReader, FileWriter, WriterError  # noqa: E402
from parquet_tpu_torch.core.column_store import ColumnChunkBuilder  # noqa: E402
from parquet_tpu_torch.core.schema import Schema  # noqa: E402
from parquet_tpu_torch.kernels.pipeline import EncodeDeclined, encode_device_column  # noqa: E402
from parquet_tpu_torch.sink import LocalFileSink, MemorySink, open_sink  # noqa: E402
from parquet_tpu_torch.sink.encoder import EncoderConfig, encode_chunk  # noqa: E402

jnp = pytest.importorskip("jax").numpy

ENGAGED = 'events_total{event="device_write_engaged"}'
DECLINED = 'events_total{event="device_write_declined"}'


def _schemas(dsl: str):
    js = parse_schema(dsl)
    return js, Schema.from_thrift(js.to_thrift())


def _jax_device(v):
    if isinstance(v, tuple):
        return tuple(jnp.asarray(x) for x in v)
    return jnp.asarray(v)


def _torch_device(v):
    if isinstance(v, tuple):
        return tuple(torch.from_numpy(np.ascontiguousarray(x).copy()) for x in v)
    return torch.from_numpy(np.ascontiguousarray(v).copy())


def write_four(dsl: str, groups, **opts):
    """The file written four ways — JAX host, JAX device, port host, port
    device — and the device routes: {name: bytes}, {name: (engaged,
    declined)}. `groups` is a list of {leaf: (host value, device value)}."""
    js, ts = _schemas(dsl)
    out, routes = {}, {}
    for pkg, W, M, schema, to_dev in (
        ("jax", JWriter, JMemorySink, js, _jax_device),
        ("torch", FileWriter, MemorySink, ts, _torch_device),
    ):
        for device in (False, True):
            snap = metrics.snapshot()
            parquet_tpu_torch.reset_write_counts()
            sink = M()
            w = W(sink, schema, **opts)
            for grp in groups:
                for leaf, (host, dev) in grp.items():
                    if device:
                        w.write_device_column(leaf, to_dev(dev))
                    else:
                        w.write_column(leaf, host)
                w.flush_row_group()
            w.close()
            out[f"{pkg} {'device' if device else 'host'}"] = sink.getvalue()
            if device:
                if pkg == "jax":
                    d = metrics.delta(snap)
                    routes[pkg] = (d.get(ENGAGED, 0), d.get(DECLINED, 0))
                else:
                    c = parquet_tpu_torch.write_counts()
                    routes[pkg] = (c["device_write_engaged"], c["device_write_declined"])
    return out, routes


def assert_all_equal(out: dict) -> bytes:
    ref = out["jax host"]
    for name, raw in out.items():
        assert raw == ref, f"{name} differs from the JAX host write"
    return ref


# -- the corpus of tests/test_device_query.py::TestDeviceWriteMatrix -----------

MATRIX_DSL = """
message w {
  required int64 hi;
  required int64 lo;
  required int64 seq;
  required binary s (UTF8);
}
"""


def matrix_groups(rows=900):
    rng = np.random.default_rng(47)
    hi = rng.integers(-(2**60), 2**60, rows).astype(np.int64)  # PLAIN
    lo = rng.integers(0, 50, rows).astype(np.int64)  # dictionary
    seq = np.cumsum(rng.integers(0, 7, rows)).astype(np.int64)  # DELTA
    strs = [f"s{i % 37}" for i in range(rows)]
    data = np.frombuffer("".join(strs).encode(), dtype=np.uint8)
    offsets = np.zeros(rows + 1, dtype=np.int64)
    np.cumsum([len(s) for s in strs], out=offsets[1:])
    grp = {"hi": (hi, hi), "lo": (lo, lo), "seq": (seq, seq), "s": (strs, (data, offsets))}
    return [grp, grp]


def write_matrix(codec, dpv, with_crc=False):
    return write_four(MATRIX_DSL, matrix_groups(), codec=codec, data_page_version=dpv,
                      with_crc=with_crc, column_encodings={"seq": "DELTA_BINARY_PACKED"})


@pytest.mark.parametrize("codec,dpv", [("snappy", 2), ("uncompressed", 1)], ids=str)
def test_device_write_matrix_fast(codec, dpv):
    out, routes = write_matrix(codec, dpv)
    assert_all_equal(out)
    # hi, lo, seq engage; s (dictionary-eligible BYTE_ARRAY) declines: 2 groups
    assert routes["torch"] == routes["jax"] == (6, 2)


@pytest.mark.parametrize("with_crc", [False, True], ids=["nocrc", "crc"])
@pytest.mark.parametrize("dpv", [1, 2])
@pytest.mark.parametrize("codec", ["uncompressed", "snappy", "gzip"])
def test_device_write_full_matrix(codec, dpv, with_crc):
    out, routes = write_matrix(codec, dpv, with_crc)
    assert_all_equal(out)
    assert routes["torch"] == routes["jax"]


def test_plain_bytearray_route_engages():
    """With the dictionary off for the string leaf, every device column
    engages, the byte-array framing included."""
    out, routes = write_four(MATRIX_DSL, matrix_groups(700), codec="snappy",
                             use_dictionary=["lo"],
                             column_encodings={"seq": "DELTA_BINARY_PACKED"})
    assert_all_equal(out)
    assert routes["torch"] == routes["jax"] == (8, 0)


# -- the TestEncodeDeviceColumn cases of tests/test_device_encode.py -------------


def _cfgs(**kw):
    base = dict(codec=0, data_page_version=1, max_page_size=1 << 20, with_crc=False,
                column_encodings={})
    base.update(kw)
    return (JEncoderConfig(write_page_index=False, bloom_specs={}, **base),
            EncoderConfig(**base))


def _chunk_bytes(ec) -> bytes:
    return b"".join(bytes(p) for p in ec.parts)


def _encode_three(dsl, leaf, values, **cfg):
    """(JAX host chunk, port host chunk, port device chunk) of one leaf."""
    js, ts = _schemas(dsl)
    jcfg, tcfg = _cfgs(**cfg)
    jb = JBuilder(js.column(leaf), True)
    jb.set_columnar(values)
    tb = ColumnChunkBuilder(ts.column(leaf), True)
    tb.set_columnar(values)
    dev = encode_device_column(ts.column(leaf), torch.from_numpy(values.copy()), tcfg)
    return j_encode_chunk(jcfg, jb, None), encode_chunk(tcfg, tb, None), dev


def _assert_chunks_equal(j, *chunks):
    for ec in chunks:
        assert _chunk_bytes(ec) == _chunk_bytes(j)
        assert ec.nbytes == j.nbytes
        assert ec.chunk.meta_data.dumps() == j.chunk.meta_data.dumps()


@pytest.mark.parametrize("codec", [0, 1])  # uncompressed, snappy
@pytest.mark.parametrize("dpv", [1, 2])
def test_encode_device_column_dict_int64(codec, dpv):
    vals = np.random.default_rng(7).integers(0, 300, 50_000).astype(np.int64)
    j, h, d = _encode_three("message m { required int64 a; }", "a", vals, codec=codec,
                            data_page_version=dpv)
    _assert_chunks_equal(j, h, d)


def test_encode_device_column_plain_double_and_crc():
    vals = np.random.default_rng(9).random(20_000)  # all-unique: no dict
    j, h, d = _encode_three("message m { required double x; }", "x", vals, codec=1,
                            with_crc=True, max_page_size=1 << 15)
    _assert_chunks_equal(j, h, d)


def test_encode_device_column_multi_page_dict_stream():
    rng = np.random.default_rng(3)
    # repeats + runs across page boundaries, tiny pages
    vals = np.repeat(rng.integers(0, 40, 3000), 4)[:10_000].astype(np.int32)
    j, h, d = _encode_three("message m { required int32 v; }", "v", vals, codec=1,
                            max_page_size=4096)
    _assert_chunks_equal(j, h, d)


def test_encode_device_column_matches_jax_device_encode():
    js, ts = _schemas("message m { required int64 a; }")
    vals = np.repeat(np.random.default_rng(2).integers(0, 9, 500), 9).astype(np.int64)
    jcfg, tcfg = _cfgs(codec=1)
    j = j_encode_device_column(js.column("a"), jnp.asarray(vals), jcfg)
    d = encode_device_column(ts.column("a"), torch.from_numpy(vals), tcfg)
    _assert_chunks_equal(j, d)


@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_encode_device_column_delta_pages(dtype):
    vals = np.cumsum(np.random.default_rng(4).integers(-50, 900, 70_000)).astype(dtype)
    physical = "int32" if dtype == "int32" else "int64"
    j, h, d = _encode_three(f"message m {{ required {physical} a; }}", "a", vals,
                            codec=1, max_page_size=1 << 16,
                            column_encodings={("a",): _delta()})
    _assert_chunks_equal(j, h, d)


def _delta():
    from parquet_tpu_torch.meta.parquet_types import Encoding

    return Encoding.DELTA_BINARY_PACKED


def test_dict_float_nan_payloads_device_equals_host():
    bits = np.random.default_rng(6).choice(
        np.array([0x7FF8000000000000, 0x7FF8000000000001, 0x3FF0000000000000,
                  0xFFF8000000000000], dtype=np.uint64), 5000)
    vals = bits.view(np.float64)
    out, routes = write_four("message m { required double x; }", [{"x": (vals, vals)}])
    assert_all_equal(out)
    assert routes["torch"] == routes["jax"] == (1, 0)


# -- typed declines ----------------------------------------------------------------


def test_byte_stream_split_declines_identically():
    x = np.random.default_rng(3).standard_normal(400)
    out, routes = write_four("message w { required double x; }", [{"x": (x, x)}],
                             column_encodings={"x": "BYTE_STREAM_SPLIT"})
    assert_all_equal(out)
    assert routes["torch"] == routes["jax"] == (0, 1)


def test_width_mismatch_declines_identically():
    """An int32 tensor for an INT64 leaf declines to the host encoder, which
    widens it exactly."""
    v = np.random.default_rng(8).integers(-1000, 1000, 600)
    out, routes = write_four("message w { required int64 a; }",
                             [{"a": (v.astype(np.int64), v.astype(np.int32))}])
    assert_all_equal(out)
    assert routes["torch"] == routes["jax"] == (0, 1)


def test_kind_mismatch_declines_to_the_host_cast():
    """int64 values for a DOUBLE leaf: the host encoder casts them exactly.
    The port declines the tensor to that cast; the JAX package engages and
    writes the integers' bit patterns as doubles (its file differs: a fault
    recorded in ROADMAP.md, not mirrored)."""
    js, ts = _schemas("message w { required double x; }")
    x = np.arange(100, dtype=np.int64) % 7

    def port(device):
        sink = MemorySink()
        with FileWriter(sink, ts) as w:
            if device:
                w.write_device_column("x", torch.from_numpy(x))
            else:
                w.write_column("x", x)
        return sink.getvalue()

    sink = JMemorySink()
    with JWriter(sink, js) as w:
        w.write_column("x", x)
    parquet_tpu_torch.reset_write_counts()
    assert port(True) == port(False) == sink.getvalue()
    c = parquet_tpu_torch.write_counts()
    assert (c["device_write_engaged"], c["device_write_declined"]) == (0, 1)


def test_encode_device_column_typed_declines():
    js, ts = _schemas("""message m { required int64 a; optional int64 b;
                         required binary s; required boolean f; }""")
    _, cfg = _cfgs()
    with pytest.raises(EncodeDeclined, match="flat REQUIRED"):
        encode_device_column(ts.column("b"), torch.zeros(4, dtype=torch.int64), cfg)
    with pytest.raises(EncodeDeclined, match="dictionary-eligible"):
        encode_device_column(ts.column("s"), (torch.zeros(0, dtype=torch.uint8),
                                              torch.zeros(1, dtype=torch.int64)), cfg)
    with pytest.raises(EncodeDeclined, match="mismatch"):
        encode_device_column(ts.column("f"), torch.zeros(4, dtype=torch.bool), cfg)
    _, indexed = _cfgs()
    indexed = EncoderConfig(**{**indexed.__dict__, "write_page_index": True})
    with pytest.raises(EncodeDeclined, match="page index"):
        encode_device_column(ts.column("a"), torch.zeros(4, dtype=torch.int64), indexed)
    _, dlba = _cfgs(column_encodings={("s",): _encoding("DELTA_LENGTH_BYTE_ARRAY")})
    with pytest.raises(EncodeDeclined, match="only PLAIN"):
        encode_device_column(ts.column("s"), (torch.zeros(0, dtype=torch.uint8),
                                              torch.zeros(1, dtype=torch.int64)), dlba,
                             enable_dict=False)


def _encoding(name):
    from parquet_tpu_torch.meta.parquet_types import Encoding

    return Encoding[name]


def test_refuses_nested_optional_and_cut_options():
    js, ts = _schemas("message m { required int64 a; optional int64 b; }")
    w = FileWriter(MemorySink(), ts)
    with pytest.raises(WriterError, match="flat REQUIRED"):
        w.write_device_column("b", torch.zeros(4, dtype=torch.int64))
    with pytest.raises(WriterError, match="torch tensors"):
        w.write_device_column("a", np.zeros(4, dtype=np.int64))
    # the row path is ported: rows are taken, and a row group of rows
    # refuses columns
    w.write_row({"a": 1})
    w.write_rows([{"a": 2, "b": 3}])
    assert w.current_row_group_rows == 2
    with pytest.raises(WriterError, match="cannot mix write_row and write_column"):
        w.write_device_column("a", torch.zeros(4, dtype=torch.int64))
    w.abort()
    w = FileWriter(MemorySink(), ts, parallel=True)
    with pytest.raises(WriterError, match="serial writer"):
        w.write_device_column("a", torch.zeros(4, dtype=torch.int64))
    w.abort()
    with pytest.raises(TypeError, match="io layer"):
        open_sink("https://example.invalid/x.parquet")


def test_row_count_mismatch_is_refused():
    _, ts = _schemas("message m { required int64 a; required int64 b; }")
    w = FileWriter(MemorySink(), ts)
    w.write_device_column("a", torch.zeros(4, dtype=torch.int64))
    with pytest.raises(WriterError, match="rows"):
        w.write_device_column("b", torch.zeros(5, dtype=torch.int64))
    w.abort()


# -- statistics, dictionaries, sinks and read-back ---------------------------------


@pytest.mark.parametrize("physical,bits", [("int32", 32), ("int64", 64)])
def test_unsigned_delta_statistics(physical, bits):
    """DELTA reduces min/max on the device in the unsigned order of a UINT
    leaf (the sign bit flipped): values on both sides of the sign bit."""
    udt = np.uint32 if bits == 32 else np.uint64
    rng = np.random.default_rng(bits)
    u = np.concatenate([rng.integers(0, 1 << (bits - 1), 500, dtype=np.uint64),
                        rng.integers(1 << (bits - 1), (1 << bits) - 1, 500, dtype=np.uint64,
                                     endpoint=True)]).astype(udt)
    rng.shuffle(u)
    v = u.view(np.int32 if bits == 32 else np.int64)
    out, routes = write_four(
        f"message m {{ required {physical} u (UINT_{bits}); }}", [{"u": (v, v)}],
        column_encodings={"u": "DELTA_BINARY_PACKED"}, use_dictionary=False)
    raw = assert_all_equal(out)
    assert routes["torch"] == routes["jax"] == (1, 0)
    with FileReader(raw, device="cpu") as r:
        st = r.metadata.row_groups[0].columns[0].meta_data.statistics
    assert int.from_bytes(st.min_value, "little") == int(u.min())
    assert int.from_bytes(st.max_value, "little") == int(u.max())


@pytest.mark.parametrize("dtype", ["int32", "int64", "float32", "float64"])
def test_host_dictionary_pinned_to_jax_native_probe(dtype):
    """The port's NumPy probe gives the JAX native probe's first-occurrence
    dictionary and indices."""
    lib = j_get_native()
    if lib is None or not lib.has_u64_dict:
        pytest.skip("the JAX package's native library is not built")
    physical = {"int32": "int32", "int64": "int64", "float32": "float", "float64": "double"}
    js, ts = _schemas(f"message m {{ required {physical[dtype]} a; }}")
    rng = np.random.default_rng(21)
    vals = rng.integers(-40, 40, 20_000).astype(dtype)
    if dtype.startswith("float"):
        vals[::17] = np.nan
    jb, tb = JBuilder(js.column("a"), True), ColumnChunkBuilder(ts.column("a"), True)
    jd, ji = jb.build_dictionary(vals)
    td, ti = tb.build_dictionary(vals)
    assert jd.tobytes() == td.tobytes()
    np.testing.assert_array_equal(np.asarray(ji, dtype=np.uint32), ti)


def test_host_byte_dictionaries_match_jax():
    js, ts = _schemas("message m { required binary s (UTF8); }")
    words = [f"w{i % 53}".encode() for i in range(3000)]
    jb, tb = JBuilder(js.column("s"), True), ColumnChunkBuilder(ts.column("s"), True)
    jd, ji = jb.build_dictionary(jb._coerce_array(words))
    td, ti = tb.build_dictionary(tb._coerce_array(words))
    assert jd.data == td.data
    np.testing.assert_array_equal(jd.offsets, td.offsets)
    np.testing.assert_array_equal(np.asarray(ji, dtype=np.uint32), ti)
    tb2 = ColumnChunkBuilder(ts.column("s"), True)
    tb2.set_columnar([w.decode() for w in words])
    sd, si = tb2.fast_dictionary()  # the str-domain probe: the same dictionary
    assert sd.data == td.data
    np.testing.assert_array_equal(si, ti)


def test_byte_array_device_pair_with_int32_offsets_and_a_base():
    """Offsets may be int32 and may start past 0 (a slice of a larger
    buffer): the device route frames exactly the slice."""
    items = [f"v{i % 9}-{'x' * (i % 5)}".encode() for i in range(400)]
    data = np.frombuffer(b"pad!" + b"".join(items), dtype=np.uint8)
    off = np.zeros(len(items) + 1, dtype=np.int64)
    np.cumsum([len(x) for x in items], out=off[1:])
    off += 4
    _, ts = _schemas("message m { required binary s; }")

    def write(device):
        sink = MemorySink()
        with FileWriter(sink, ts, enable_dictionary=False, max_page_size=512) as w:
            if device:
                w.write_device_column("s", (torch.from_numpy(data.copy()),
                                            torch.from_numpy(off.astype(np.int32))))
            else:
                w.write_column("s", items)
        return sink.getvalue()

    parquet_tpu_torch.reset_write_counts()
    assert write(True) == write(False)
    assert parquet_tpu_torch.write_counts()["device_write_engaged"] == 1


def test_read_back_through_the_port_reader(tmp_path):
    rng = np.random.default_rng(12)
    n = 5000
    a = np.repeat(rng.integers(0, 20, n // 10), 10).astype(np.int32)
    b = np.cumsum(rng.integers(0, 100, n)).astype(np.int64)
    c = rng.random(n)
    words = [f"s{i % 300}".encode() for i in range(n)]
    data = np.frombuffer(b"".join(words), dtype=np.uint8)
    off = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([len(w) for w in words], out=off[1:])
    _, ts = _schemas("""message m { required int32 a; required int64 b;
                        required double c; required binary s; }""")
    path = tmp_path / "out.parquet"
    with FileWriter(path, ts, codec="snappy", use_dictionary=["a"],
                    column_encodings={"b": "DELTA_BINARY_PACKED"}) as w:
        for lo, hi in ((0, 3000), (3000, n)):
            w.write_device_column("a", torch.from_numpy(a[lo:hi].copy()))
            w.write_device_column("b", torch.from_numpy(b[lo:hi].copy()))
            w.write_device_column("c", torch.from_numpy(c[lo:hi].copy()))
            w.write_device_column("s", (torch.from_numpy(data.copy()),
                                        torch.from_numpy(off[lo : hi + 1].copy())))
            w.flush_row_group()
    with FileReader(path, device="cpu") as r:
        groups = r.read_row_groups_device()
    got = {k: [] for k in "abcs"}
    for g in groups:
        for k in "abc":
            got[k].append(g[(k,)].values.numpy())
        col = g[("s",)]
        o = col.offsets.numpy()
        raw = col.data.numpy().tobytes()
        got["s"] += [raw[o[i] : o[i + 1]] for i in range(len(o) - 1)]
    np.testing.assert_array_equal(np.concatenate(got["a"]), a)
    np.testing.assert_array_equal(np.concatenate(got["b"]), b)
    np.testing.assert_array_equal(np.concatenate(got["c"]).view(np.uint64), c.view(np.uint64))
    assert got["s"] == words


def test_local_file_sink_is_atomic(tmp_path):
    _, ts = _schemas("message m { required int64 a; }")
    path = tmp_path / "x.parquet"
    w = FileWriter(path, ts)
    w.write_device_column("a", torch.arange(10))
    w.flush_row_group()
    assert not path.exists()  # bytes go to a temp file until close
    w.abort()
    assert not path.exists() and not list(tmp_path.iterdir())
    with FileWriter(path, ts) as w:
        w.write_device_column("a", torch.arange(10))
    assert path.exists() and isinstance(open_sink(str(path))[0], LocalFileSink)


def test_optional_host_column_beside_device_columns():
    """An OPTIONAL leaf goes through write_column with def levels while the
    others are device columns, as the write phase of chip_smoke.py does."""
    js, ts = _schemas("message m { required int64 a; optional int32 p; }")
    rng = np.random.default_rng(14)
    a = rng.integers(0, 5, 800).astype(np.int64)
    valid = rng.random(800) > 0.1
    p = rng.integers(0, 7, int(valid.sum())).astype(np.int32)
    defs = valid.astype(np.uint16)

    def write(W, sink, schema, dev):
        with W(sink, schema, codec="gzip") as w:
            w.write_column("p", p, def_levels=defs)
            if dev is None:
                w.write_column("a", a)
            else:
                w.write_device_column("a", dev(a))
        return sink.getvalue()

    want = write(JWriter, JMemorySink(), js, None)
    assert write(JWriter, JMemorySink(), js, jnp.asarray) == want
    assert write(FileWriter, MemorySink(), ts, None) == want
    assert write(FileWriter, MemorySink(), ts, torch.from_numpy) == want
    buf = io.BytesIO()
    write(FileWriter, buf, ts, torch.from_numpy)
    assert buf.getvalue() == want
