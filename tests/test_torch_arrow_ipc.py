"""The port's Arrow IPC stream codec (parquet_tpu_torch.core.arrow_ipc)
against pyarrow.ipc, on the CPU.

  * Writer: for the same table (pyarrow's, read into the port's arrays by
    the port's reader), the port's stream matches pyarrow's new_stream /
    write_table message by message: the same count and kinds, the same
    body bytes, metadata that pyarrow decodes to the same schema and
    batches, and the same field nodes and buffer spans; the flatbuffers
    themselves come out byte-identical, so the whole streams are.
    Sliced arrays, multi-chunk tables, dictionaries that change between
    batches (a replacement DictionaryBatch) and zero-row tables included.
  * Reader: over pyarrow-written streams of every type the port accepts,
    dictionaries (replacement and delta batches), sliced arrays, ZSTD and
    LZ4_FRAME bodies and the legacy framing, to_pylist() equals pyarrow's;
    offsets that do not start at 0 read too.
  * Refusals: a big-endian stream, an unsupported type, a schema that
    differs from the writer's (SchemaMismatch), and malformed streams
    (every truncation of a stream, a bad token, a buffer past its body,
    corrupted bytes) raise ArrowInvalid, never a bare struct.error or
    IndexError.

Tolerance: exact bytes and values.
"""

from __future__ import annotations

import datetime as dt
import decimal
import io
import struct

import numpy as np
import pytest

pa = pytest.importorskip("pyarrow")

from parquet_tpu_torch.core import arrow_format as paf  # noqa: E402
from parquet_tpu_torch.core import arrow_ipc  # noqa: E402
from parquet_tpu_torch.core.arrow_ipc import ArrowInvalid  # noqa: E402


def pa_stream(table, batches=None, **options) -> bytes:
    buf = io.BytesIO()
    with pa.ipc.new_stream(buf, table.schema, options=pa.ipc.IpcWriteOptions(**options)) as w:
        if batches is None:
            w.write_table(table)
        else:
            for b in batches:
                w.write_batch(b)
    return buf.getvalue()


def messages(stream: bytes) -> list:
    reader = pa.ipc.MessageReader.open_stream(stream)
    out = []
    while True:
        try:
            out.append(reader.read_next_message())
        except StopIteration:
            return out


def nodes_and_spans(msg):
    """(field nodes, buffer spans) of a batch or dictionary message, read
    by the port's flatbuffer reader."""
    header = arrow_ipc._root(msg.metadata.to_pybytes()).table(2)
    if msg.type == "dictionary":
        header = header.table(1)
    return header.structs16(1), header.structs16(2)


def _rng():
    return np.random.default_rng(2026)


def tables() -> dict:
    rng = _rng()
    n = 97
    mask = rng.random(n) < 0.2
    strings = [None if m else "s" * int(k) for m, k in zip(mask, rng.integers(0, 5, n))]
    return {
        "ints": pa.table({
            f"{s}{w}": pa.array(rng.integers(0, 100, n).astype(f"{s[0]}{w // 8}"), mask=mask)
            for s in ("int", "uint") for w in (8, 16, 32, 64)
        }),
        "floats_bools": pa.table({
            "h": pa.array(rng.standard_normal(n).astype(np.float16)),
            "f": pa.array(rng.standard_normal(n).astype(np.float32), mask=mask),
            "d": pa.array(rng.standard_normal(n)),
            "b": pa.array([bool(x) for x in rng.integers(0, 2, n)], mask=mask),
            "z": pa.array([None] * n, pa.null()),
        }),
        "binary": pa.table({
            "s": pa.array(strings, pa.string()),
            "ls": pa.array(strings, pa.large_string()),
            "b": pa.array([None if x is None else x.encode() for x in strings], pa.binary()),
            "lb": pa.array([None if x is None else x.encode() for x in strings], pa.large_binary()),
            "fx": pa.array([None if x is None else (x + "____")[:4].encode() for x in strings],
                           pa.binary(4)),
        }),
        "temporal": pa.table({
            "d": pa.array(rng.integers(-9999, 9999, n).astype(np.int32), pa.date32()),
            "t32s": pa.array(rng.integers(0, 86_400, n).astype(np.int32), pa.time32("s")),
            "t32": pa.array(rng.integers(0, 86_400_000, n).astype(np.int32), pa.time32("ms")),
            "t64": pa.array(rng.integers(0, 86_400_000_000, n), pa.time64("us")),
            "t64n": pa.array(rng.integers(0, 86_400_000_000_000, n), pa.time64("ns")),
            "ts": pa.array(rng.integers(0, 10**15, n), pa.timestamp("us"), mask=mask),
            "tss": pa.array(rng.integers(0, 10**9, n), pa.timestamp("s")),
            "tsms": pa.array(rng.integers(0, 10**12, n), pa.timestamp("ms", tz="UTC")),
            "tsn": pa.array(rng.integers(0, 10**17, n), pa.timestamp("ns")),
            "tsz": pa.array(rng.integers(0, 10**15, n), pa.timestamp("us", tz="America/New_York")),
        }),
        "decimal": pa.table({
            "d": pa.array([None if m else decimal.Decimal(int(v)).scaleb(-2)
                           for m, v in zip(mask, rng.integers(-10**12, 10**12, n))],
                          pa.decimal128(20, 2)),
            "d38": pa.array([decimal.Decimal("-" + "9" * 38), decimal.Decimal(0), None] * 32
                            + [decimal.Decimal(1)] * (n - 96), pa.decimal128(38, 0)),
        }),
        "nested": pa.table({
            "l": pa.array([None if m else list(range(int(k))) for m, k in
                           zip(mask, rng.integers(0, 4, n))], pa.list_(pa.int32())),
            "ll": pa.array([[["a"], None, []] if i % 3 else None for i in range(n)],
                           pa.large_list(pa.list_(pa.string()))),
            "st": pa.array([None if i % 7 == 0 else {"a": i, "b": str(i) if i % 2 else None}
                            for i in range(n)], pa.struct([("a", pa.int64()), ("b", pa.string())])),
            "m": pa.array([None if i % 5 == 0 else [(f"k{j}", j if j % 2 else None)
                                                    for j in range(i % 3)] for i in range(n)],
                          pa.map_(pa.string(), pa.int64())),
            "nn": pa.array([{"x": [1.5, None]} if i % 2 else {"x": None} for i in range(n)],
                           pa.struct([pa.field("x", pa.list_(pa.field("e", pa.float64())),
                                               nullable=False)])),
        }),
        "dictionary": pa.table({
            "d": pa.array(strings).dictionary_encode(),
            "d16": pa.DictionaryArray.from_arrays(
                pa.array(rng.integers(0, 3, n).astype(np.int16), mask=mask),
                pa.array([1.5, 2.5, -3.0])),
            "ld": pa.array([["x", "y"] if i % 2 else ["y"] for i in range(n)],
                           pa.list_(pa.dictionary(pa.int32(), pa.string()))),
        }),
    }


TABLES = tables()


@pytest.mark.parametrize("name", sorted(TABLES))
@pytest.mark.parametrize("window", [None, (1, 60), (13, 0), (96, 1)], ids=["whole", "slice",
                                                                            "empty", "tail"])
def test_writer_matches_pyarrow_message_by_message(name, window):
    table = TABLES[name]
    if window is not None:
        table = table.slice(*window)
    want = pa_stream(table)
    ours = arrow_ipc.open_stream(want).read_all()
    got = arrow_ipc.serialize_table(ours)
    mw, mg = messages(want), messages(got)
    assert [m.type for m in mg] == [m.type for m in mw]
    schema = pa.ipc.read_schema(mg[0])
    assert schema.equals(pa.ipc.read_schema(mw[0]))
    for a, b in zip(mg[1:], mw[1:]):
        assert a.body.to_pybytes() == b.body.to_pybytes()
        assert nodes_and_spans(a) == nodes_and_spans(b)
        if a.type == "record batch" and name != "dictionary":
            assert pa.ipc.read_record_batch(a, schema).equals(pa.ipc.read_record_batch(b, schema))
    # the flatbuffers too: the streams are byte-identical
    assert got == want
    assert pa.ipc.open_stream(got).read_all().equals(table)


def test_multi_chunk_tables_and_changing_dictionaries():
    """One RecordBatch a row range of the chunks; a dictionary that changes
    between batches is sent again as a replacement, as pyarrow's stream
    writer sends it, and an equal one is not."""
    a = pa.chunked_array([pa.array(["a", "b"]).dictionary_encode(),
                          pa.array(["a", "b"]).dictionary_encode(),
                          pa.array(["c", "a", None]).dictionary_encode()])
    b = pa.chunked_array([pa.array([1, 2, 3, 4]), pa.array([5, 6, 7])])
    table = pa.table({"a": a, "b": b})
    want = pa_stream(table)
    got = arrow_ipc.serialize_table(arrow_ipc.open_stream(want).read_all())
    assert got == want
    kinds = [m.type for m in messages(got)]
    assert kinds.count("dictionary") == 2 and kinds.count("record batch") == 3


def test_writer_refuses_another_schema():
    sink = io.BytesIO()
    w = arrow_ipc.new_stream(sink, paf.schema([paf.field("x", paf.int64())]))
    w.write_table(paf.table({"x": paf.array(np.arange(3))}))
    with pytest.raises(arrow_ipc.SchemaMismatch):
        w.write_table(paf.table({"x": paf.array(np.arange(3, dtype=np.int32))}))
    w.close()
    assert pa.ipc.open_stream(sink.getvalue()).read_all().num_rows == 3


def test_empty_table_is_schema_and_end_of_stream():
    table = TABLES["nested"].slice(0, 0)
    got = arrow_ipc.serialize_table(arrow_ipc.open_stream(pa_stream(table)).read_all())
    assert got == pa_stream(table)
    assert [m.type for m in messages(got)] == ["schema"]
    assert got.endswith(b"\xff\xff\xff\xff\x00\x00\x00\x00")


# -- the reader ----------------------------------------------------------------------


def norm(rows: list) -> list:
    """timestamp[ns] values compared by their nanoseconds: pyarrow gives a
    pandas.Timestamp, the port its NanoTimestamp rendering of one."""
    def one(v):
        if isinstance(v, paf.NanoTimestamp) or type(v).__name__ == "Timestamp":
            return ("ns", v.value)
        return v
    return [{k: one(v) for k, v in r.items()} for r in rows]


READ_OPTIONS = [
    {},
    {"compression": "zstd"},
    {"compression": "lz4"},
    {"use_legacy_format": True},
]


@pytest.mark.parametrize("options", READ_OPTIONS, ids=["plain", "zstd", "lz4", "legacy"])
@pytest.mark.parametrize("name", sorted(TABLES))
def test_reader_equals_pyarrow(name, options):
    table = TABLES[name]
    for t in (table, table.slice(5, 40)):
        stream = pa_stream(t, **options)
        want = pa.ipc.open_stream(stream).read_all()
        reader = arrow_ipc.open_stream(stream)
        got = reader.read_all()
        assert norm(got.to_pylist()) == norm(want.to_pylist())
        assert got.num_rows == want.num_rows
        assert [f.name for f in reader.schema] == want.schema.names


def test_reader_takes_big_compressed_buffers():
    """Multi-block LZ4 frames (linked 64 KiB blocks) and large ZSTD buffers."""
    n = 300_000
    rng = np.random.default_rng(4)
    table = pa.table({"x": pa.array(rng.integers(0, 50, n)),
                      "s": pa.array([f"v{i % 97}" for i in range(n)])})
    for codec in ("lz4", "zstd"):
        stream = pa_stream(table, compression=codec)
        got = arrow_ipc.open_stream(stream).read_all()
        assert got.to_pylist() == table.to_pylist()


def test_reader_takes_replacement_and_delta_dictionaries():
    schema = pa.schema([("d", pa.dictionary(pa.int32(), pa.string()))])
    b1 = pa.record_batch([pa.DictionaryArray.from_arrays(pa.array([0, 1], pa.int32()),
                                                         pa.array(["a", "b"]))], schema=schema)
    b2 = pa.record_batch([pa.DictionaryArray.from_arrays(pa.array([2, 0], pa.int32()),
                                                         pa.array(["a", "b", "c"]))], schema=schema)
    b3 = pa.record_batch([pa.DictionaryArray.from_arrays(pa.array([0, None], pa.int32()),
                                                         pa.array(["z"]))], schema=schema)
    table = pa.Table.from_batches([b1, b2, b3])
    for deltas in (False, True):
        stream = pa_stream(table, [b1, b2, b3], emit_dictionary_deltas=deltas)
        kinds = [m.type for m in messages(stream)]
        assert kinds.count("dictionary") == 3
        got = arrow_ipc.open_stream(stream).read_all()
        assert got.to_pylist() == table.to_pylist() == [
            {"d": "a"}, {"d": "b"}, {"d": "c"}, {"d": "a"}, {"d": "z"}, {"d": None}]


def test_reader_takes_offsets_that_do_not_start_at_zero(monkeypatch):
    """A writer may send a sliced string or list array's offsets as they
    lie in memory; the reader reads them as absolute into the data."""
    t = paf.table({
        "s": paf.Array.from_buffers(paf.string(), 2, [None, np.array([3, 5, 6], np.int32),
                                                      b"abcdef"]),
        "l": paf.Array.from_buffers(paf.list_(paf.int32()), 2, [None, np.array([1, 3, 4],
                                                                             np.int32)],
                                    children=[paf.array(np.arange(6, dtype=np.int32))]),
    })

    def as_they_lie(a, dt):
        return a._buffers[1], 0, int(a.offsets_np()[-1])

    monkeypatch.setattr(arrow_ipc, "_offsets_zero_based", as_they_lie)
    stream = arrow_ipc.serialize_table(t)
    monkeypatch.undo()
    assert arrow_ipc.open_stream(stream).read_all().to_pylist() == [
        {"s": "de", "l": [1, 2]}, {"s": "f", "l": [3]}]
    assert pa.ipc.open_stream(stream).read_all().to_pylist() == [
        {"s": "de", "l": [1, 2]}, {"s": "f", "l": [3]}]


# -- refusals --------------------------------------------------------------------------


def _big_endian_schema() -> bytes:
    b = arrow_ipc._Builder()
    fields = [arrow_ipc._field_table(b, paf.field("x", paf.int64()), {})]
    vec = b.vector_offsets(fields)
    b.start(4)
    b.add(0, "h", 1, 0)  # Endianness.Big
    b.add_offset(1, vec)
    meta = arrow_ipc._message(b, arrow_ipc._HDR_SCHEMA, b.end(), 0)
    return b"".join(arrow_ipc._frame(meta, [])) + arrow_ipc.EOS


def test_big_endian_stream_is_refused():
    with pytest.raises(ArrowInvalid, match="big-endian"):
        arrow_ipc.open_stream(_big_endian_schema())


@pytest.mark.parametrize("arr", [
    pa.array([1, 2], pa.duration("s")),
    pa.array([1, 2], pa.date64()),
    pa.array(["a", "b"], pa.string_view()),
    pa.FixedSizeListArray.from_arrays(pa.array([1, 2, 3, 4]), 2),
    pa.array([pa.MonthDayNano([1, 2, 3])], pa.month_day_nano_interval()),
    pa.UnionArray.from_sparse(pa.array([0, 1], pa.int8()),
                              [pa.array([1, 2]), pa.array(["a", "b"])]),
    pa.array([1, 2], pa.decimal256(40, 2)),
], ids=["duration", "date64", "string_view", "fixed_size_list", "interval", "union",
        "decimal256"])
def test_unsupported_types_are_refused(arr):
    with pytest.raises(ArrowInvalid):
        arrow_ipc.open_stream(pa_stream(pa.table({"x": arr}))).read_all()


def test_every_truncation_is_a_typed_error():
    stream = pa_stream(TABLES["nested"].slice(0, 9))
    eos = len(stream) - 8
    for cut in range(len(stream)):
        try:
            arrow_ipc.open_stream(stream[:cut]).read_all()
        except ArrowInvalid:
            continue
        # a cut that drops only the end marker, or lands on a message
        # boundary, leaves a valid (shorter) stream
        assert cut >= eos or stream[cut : cut + 4] == b"\xff\xff\xff\xff", cut


def test_corrupt_streams_are_typed_errors():
    stream = pa_stream(TABLES["binary"].slice(0, 20))
    with pytest.raises(ArrowInvalid):
        arrow_ipc.open_stream(b"")
    with pytest.raises(ArrowInvalid):
        arrow_ipc.open_stream(b"\xff\xff\xff\xff\xff\xff\xff\x7f" + stream[8:])
    # a record batch whose buffer lies past the body
    msgs = messages(stream)
    batch = msgs[1]
    meta = bytearray(batch.metadata.to_pybytes())
    spans = nodes_and_spans(batch)[1]
    raw = struct.pack("<qq", *spans[-1])
    at = bytes(meta).rindex(raw)
    meta[at : at + 16] = struct.pack("<qq", spans[-1][0], 1 << 20)
    bad = b"".join(arrow_ipc._frame(bytes(meta), [batch.body.to_pybytes()]))
    schema_part = b"".join(arrow_ipc._frame(msgs[0].metadata.to_pybytes(), []))
    with pytest.raises(ArrowInvalid, match="past the message body"):
        arrow_ipc.open_stream(schema_part + bad + arrow_ipc.EOS).read_all()
    # seeded byte flips: a typed error or a stream that still parses
    rng = np.random.default_rng(7)
    for _ in range(300):
        mutated = bytearray(stream)
        for pos in rng.integers(0, len(stream), 3):
            mutated[pos] = int(rng.integers(0, 256))
        try:
            arrow_ipc.open_stream(bytes(mutated)).read_all().to_pylist()
        except ArrowInvalid:
            pass


@pytest.mark.parametrize("codec", ["lz4", "zstd"])
@pytest.mark.parametrize("declared", ["huge", "past_ratio"])
def test_an_over_large_declared_length_is_refused(codec, declared):
    """A compressed buffer whose length prefix declares more bytes than its
    codec can expand its payload to is a typed error, raised before any
    buffer is allocated, and an append of it is the lake's bad_payload."""
    from parquet_tpu_torch.lake.ingest import rows_from_payload
    from parquet_tpu_torch.lake.manifest import LakeError

    stream = pa_stream(TABLES["ints"], compression=codec)
    msgs = messages(stream)
    batch = msgs[1]
    body = bytearray(batch.body.to_pybytes())
    offset, length = max(nodes_and_spans(batch)[1], key=lambda sp: sp[1])
    payload = length - 8
    ratio = arrow_ipc._MAX_RATIO[arrow_ipc._LZ4_FRAME if codec == "lz4" else arrow_ipc._ZSTD]
    n = (1 << 62) if declared == "huge" else ratio * payload + 1
    body[offset : offset + 8] = struct.pack("<q", n)
    bad = b"".join(arrow_ipc._frame(msgs[0].metadata.to_pybytes(), [])
                   + arrow_ipc._frame(batch.metadata.to_pybytes(), [bytes(body)])) + arrow_ipc.EOS
    with pytest.raises(ArrowInvalid, match="more than its codec can expand to"):
        arrow_ipc.open_stream(bad).read_all()
    with pytest.raises(LakeError) as ei:
        rows_from_payload(bad, "application/vnd.apache.arrow.stream")
    assert ei.value.code == "bad_payload"


def test_a_batch_before_any_schema_is_refused():
    stream = pa_stream(TABLES["ints"].slice(0, 3))
    msgs = messages(stream)
    only_batch = b"".join(arrow_ipc._frame(msgs[1].metadata.to_pybytes(),
                                           [msgs[1].body.to_pybytes()]))
    with pytest.raises(ArrowInvalid, match="Schema"):
        arrow_ipc.open_stream(only_batch)


# -- no pyarrow in the port ---------------------------------------------------------

_NO_PYARROW = r'''
import http.client, json, os, sys, tempfile
import numpy as np
from parquet_tpu_torch import FileWriter, FileReader, parse_schema
from parquet_tpu_torch.core import arrow_ipc
from parquet_tpu_torch.lake.ingest import rows_from_payload
from parquet_tpu_torch.serve import ScanServer, ServeConfig
from parquet_tpu_torch.serve import mesh
from parquet_tpu_torch.tools import parquet_tool
d = tempfile.mkdtemp()
with FileWriter(os.path.join(d, "a.parquet"),
                parse_schema("message m { required int64 k; optional binary v (STRING); }")) as w:
    w.write_column("k", np.arange(10, dtype=np.int64))
    w.write_column("v", [b"x", b"y"], def_levels=[1, 1] + [0] * 8)
with FileReader(os.path.join(d, "a.parquet"), device="cpu") as r:
    table = r.to_arrow(filters=[("k", ">", 0)])
assert table.num_rows == 9
assert len(rows_from_payload(arrow_ipc.serialize_table(table),
                             "application/vnd.apache.arrow.stream")) == 9
servers = [ScanServer(ServeConfig(port=0, root=d, device="cpu")).start_background()
           for _ in range(2)]
router = mesh.MeshRouter(mesh.MeshConfig(port=0, replicas=(servers[1].url,))).start_background()
try:
    for s in (servers[0], router):
        c = http.client.HTTPConnection(s.host, s.port, timeout=30)
        c.request("POST", "/v1/scan", json.dumps({"paths": "a.parquet", "format": "arrow-ipc"}))
        resp = c.getresponse()
        body = resp.read()
        assert resp.status == 200, body
        assert arrow_ipc.open_stream(body).read_all().num_rows == 10
finally:
    router.close()
    for s in servers:
        s.close()
print(sorted(m for m in sys.modules if m == "pyarrow" or m.startswith("pyarrow.")))
'''


def test_the_arrow_paths_load_no_pyarrow():
    """The daemon's, the router's and the lake's arrow-ipc paths, to_arrow
    and the stream codec run, in a process of their own, without pyarrow
    ever being imported (this sandbox has pyarrow installed; the card's
    machine has none)."""
    import pathlib
    import subprocess
    import sys

    repo = pathlib.Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", _NO_PYARROW], cwd=repo, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_source_scan_finds_no_pyarrow_imports():
    import ast
    import pathlib

    repo = pathlib.Path(__file__).resolve().parent.parent
    files = sorted((repo / "parquet_tpu_torch").rglob("*.py")) + [repo / "chip_smoke.py"]
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                names = [node.module]
            for mod in names:
                assert mod.split(".")[0] != "pyarrow", f"{f}: imports {mod}"


def test_a_schema_nested_past_the_limit_is_refused():
    t = paf.int32()
    for _ in range(arrow_ipc._MAX_DEPTH + 2):
        t = paf.large_list(t)
    stream = b"".join(arrow_ipc._frame(arrow_ipc._schema_message(
        paf.schema([paf.field("x", t)]), {}), [])) + arrow_ipc.EOS
    with pytest.raises(ArrowInvalid, match="nested"):
        arrow_ipc.open_stream(stream)
