"""The port's host value functions against the JAX package's, on the CPU.

* Every value function of the port's host library (native/values.cc, and
  the hybrid prescan and page-header parser of native/prepare.cc) returns
  what the JAX package's native library returns on the same seeded inputs,
  byte for byte, and what the port's Python oracle of it returns: the PLAIN
  byte-array gather and encode, the byte-array take, the page-header parse,
  the hybrid prescan, decode and encode, the DELTA decode and encode, XXH64,
  the byte-array min/max and both dictionary probes. Edge cases: empty input,
  zero-length and multibyte strings, runs of identical strings, truncated
  and overlong length prefixes, out-of-range indices, every hybrid width,
  DELTA wrap-around, the dictionary cutoff and one past it, NaN payloads and
  -0.0, min/max ties and shared prefixes.
* Each call site answers through the host library: a failed host build
  raises HostBuildError there rather than answering from Python.
* Every ctypes argument of the host library has its C parameter's width.
* A small taxi-shaped file reads through the port's host read, staged walk
  and fused walk equal to the JAX reader, and the port's host write of its
  columns equals the JAX package's byte for byte.
"""

import ctypes
import io
import os
import re
from contextlib import contextmanager

import numpy as np
import pytest

pytest.importorskip("torch")

import parquet_tpu.kernels.device_ops  # noqa: E402,F401  (turns x64 on first)
from parquet_tpu.core import bloom as jbloom  # noqa: E402
from parquet_tpu.core import chunk as jchunk  # noqa: E402
from parquet_tpu.core import stats as jstats  # noqa: E402
from parquet_tpu.core.arrays import ByteArrayData as JBytes  # noqa: E402
from parquet_tpu.core.column_store import ColumnChunkBuilder as JBuilder  # noqa: E402
from parquet_tpu.core.reader import FileReader as JReader  # noqa: E402
from parquet_tpu.core.writer import FileWriter as JWriter  # noqa: E402
from parquet_tpu.meta.parquet_types import Type as JT  # noqa: E402
from parquet_tpu.ops import delta as jdelta  # noqa: E402
from parquet_tpu.ops import plain as jplain  # noqa: E402
from parquet_tpu.ops import rle_hybrid as jhybrid  # noqa: E402
from parquet_tpu.schema.dsl import parse_schema  # noqa: E402
from parquet_tpu.sink import MemorySink as JMemorySink  # noqa: E402
from parquet_tpu.utils.native import get_native as j_native  # noqa: E402

from parquet_tpu_torch import FileReader, FileWriter  # noqa: E402
from parquet_tpu_torch.core import bloom as tbloom  # noqa: E402
from parquet_tpu_torch.core import chunk as tchunk  # noqa: E402
from parquet_tpu_torch.core import stats as tstats  # noqa: E402
from parquet_tpu_torch.core.arrays import ByteArrayData  # noqa: E402
from parquet_tpu_torch.core.column_store import (  # noqa: E402
    DICT_MAX_UNIQUES,
    ColumnChunkBuilder,
    _bytes_first_occurrence_dictionary,
    _first_occurrence_dictionary,
)
from parquet_tpu_torch.core.schema import Schema  # noqa: E402
from parquet_tpu_torch.kernels import host_build  # noqa: E402
from parquet_tpu_torch.kernels import pipeline as tpipe  # noqa: E402
from parquet_tpu_torch.meta.parquet_types import CompressionCodec as C  # noqa: E402
from parquet_tpu_torch.meta.parquet_types import Encoding as E  # noqa: E402
from parquet_tpu_torch.meta.parquet_types import Type as T  # noqa: E402
from parquet_tpu_torch.ops import delta as tdelta  # noqa: E402
from parquet_tpu_torch.ops import plain as tplain  # noqa: E402
from parquet_tpu_torch.ops import rle_hybrid as thybrid  # noqa: E402
from parquet_tpu_torch.sink import MemorySink  # noqa: E402
from parquet_tpu_torch.testing.synth import ColumnSpec, column_values, write_file  # noqa: E402
from parquet_tpu_torch.utils import native as tnative  # noqa: E402


@pytest.fixture(scope="module")
def tlib():
    return tnative.get_native()


@pytest.fixture(scope="module")
def jlib():
    lib = j_native()
    assert lib is not None, "the JAX package's native library (native/build) is missing"
    return lib


def _plain_stream(items) -> bytes:
    return b"".join(len(x).to_bytes(4, "little") + x for x in items)


def _same(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    if hasattr(a, "offsets"):
        return (hasattr(b, "offsets") and np.array_equal(a.offsets, b.offsets)
                and a.offsets.dtype == b.offsets.dtype and bytes(a.data) == bytes(b.data))
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def _items(label: str, seed: int = 3) -> list[bytes]:
    rng = np.random.default_rng(seed)
    if label == "empty":
        return []
    if label == "zero_length":
        return [b""] * 17
    if label == "utf8":
        words = ["zürich", "東京", "ß", "", "naïve café", "😀x", "a"]
        return [words[i % len(words)].encode() for i in range(300)]
    if label == "runs":
        return [b"same-string"] * 40 + [b"other"] * 9 + [b""] * 8 + [b"same-string"] * 3
    lens = rng.integers(0, 40, 2000)
    return [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in lens]


ITEM_CASES = ["empty", "zero_length", "utf8", "runs", "random"]


# -- item 1: the PLAIN byte-array gather -----------------------------------------


@pytest.mark.parametrize("label", ITEM_CASES)
def test_byte_array_gather_matches_jax_and_oracle(tlib, jlib, label):
    items = _items(label)
    stream = _plain_stream(items) + b"\x07trailer"
    n = len(items)
    t_off, t_flat, t_used = tlib.byte_array_gather(stream, n)
    j_off, j_flat, j_used = jlib.byte_array_gather(stream, n)
    assert np.array_equal(t_off, j_off) and t_flat == j_flat and t_used == j_used
    oracle, o_used = tplain.byte_array_gather_plain(memoryview(stream), n)
    assert np.array_equal(oracle.offsets, t_off) and oracle.data == t_flat and o_used == t_used
    got, used = tplain.decode_plain(stream, n, T.BYTE_ARRAY)
    want, w_used = jplain.decode_plain(stream, n, JT.BYTE_ARRAY)
    assert _same(got, want) and used == w_used == len(stream) - 8
    assert got.to_list() == items


@pytest.mark.parametrize("cut", ["mid_prefix", "length_past_page"])
def test_byte_array_gather_errors_match_jax(tlib, jlib, cut):
    items = _items("utf8")
    stream = _plain_stream(items)
    if cut == "mid_prefix":
        stream = stream + b"\x05\x00"  # one more value, its prefix cut short
    else:
        stream = stream + (1 << 20).to_bytes(4, "little") + b"abc"
    n = len(items) + 1
    with pytest.raises(tplain.PlainError) as t_err:
        tplain.decode_plain(stream, n, T.BYTE_ARRAY)
    with pytest.raises(jplain.PlainError) as j_err:
        jplain.decode_plain(stream, n, JT.BYTE_ARRAY)
    assert str(t_err.value) == str(j_err.value) == "native: corrupt byte_array stream"
    with pytest.raises(tplain.PlainError):
        tplain.byte_array_gather_plain(memoryview(stream), n)
    for lib in (tlib, jlib):
        with pytest.raises(ValueError, match="corrupt byte_array stream"):
            lib.byte_array_gather(stream, n)


# -- item 2: the byte-array take -----------------------------------------------


@pytest.mark.parametrize("label", ITEM_CASES)
def test_bytearray_take_matches_jax_and_oracle(tlib, jlib, label):
    items = _items(label)
    t, j = ByteArrayData.from_list(items), JBytes.from_list(items)
    rng = np.random.default_rng(5)
    for idx in (np.zeros(0, np.int64), rng.integers(0, max(len(items), 1), 3 * len(items)),
                np.arange(len(items))[::-1]):
        if not len(items):
            idx = idx[:0]
        got = t.take(idx)
        assert _same(got, j.take(idx)) and _same(got, t.take_plain(idx))
    if items:
        idx = rng.integers(0, len(items), 50).astype(np.int64)
        lengths = np.diff(t.offsets)[idx]
        new_off = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
        total = int(new_off[-1])
        assert (tlib.bytearray_take(t.data, t.offsets, idx, new_off, total)
                == jlib.bytearray_take(j.data, j.offsets, idx, new_off, total))


def test_bytearray_take_out_of_range_matches_jax(tlib, jlib):
    items = _items("utf8")
    t, j = ByteArrayData.from_list(items), JBytes.from_list(items)
    for bad in ([0, len(items)], [-1, 2]):
        with pytest.raises(IndexError, match="out of range"):
            t.take(bad)
        with pytest.raises(IndexError, match="out of range"):
            t.take_plain(bad)
        with pytest.raises(IndexError, match="out of range"):
            j.take(bad)
    idx = np.array([0, len(items)], np.int64)
    new_off = np.array([0, 1, 2], np.int64)
    for lib, col in ((tlib, t), (jlib, j)):
        with pytest.raises(ValueError, match="native: byte-array take index out of range"):
            lib.bytearray_take(col.data, col.offsets, idx, new_off, 2)


# -- item 3: the page-header parse ----------------------------------------------


def _synth_pages_file(tmp_path, version: int, codec):
    rng = np.random.default_rng(version)
    n = 3000
    words = ByteArrayData.from_list([f"w{i}-{'x' * (i % 9)}".encode() for i in range(200)])
    specs = [
        ColumnSpec("a", T.INT64, values=rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64),
                   codec=codec, page_version=version),
        ColumnSpec("d", T.INT64, values=np.cumsum(rng.integers(0, 9, n)).astype(np.int64),
                   encoding=E.DELTA_BINARY_PACKED, codec=codec, page_version=version),
        ColumnSpec("s", T.BYTE_ARRAY, encoding=E.RLE_DICTIONARY, codec=codec, utf8=True,
                   page_version=version, valid=rng.random(n) > 0.1, dictionary=words,
                   indices=None),
    ]
    valid = specs[2].valid
    specs[2].indices = rng.integers(0, 200, int(valid.sum())).astype(np.int32)
    path = tmp_path / f"pages-v{version}.parquet"
    write_file(path, specs, row_group_rows=1500, page_bytes=2048)
    return path.read_bytes()


def _page_offsets(raw: bytes):
    """(start, end) of every chunk's page bytes, by the JAX reader's metadata."""
    with JReader(io.BytesIO(raw)) as jr:
        for i in range(jr.num_row_groups):
            for cc in jr.row_group(i).columns:
                off, total = jchunk.chunk_byte_range(cc)
                yield off, off + total


def _strip_stats(h):
    for part in (h.data_page_header, h.data_page_header_v2):
        if part is not None:
            part.statistics = None
    return h


@pytest.mark.parametrize("version", [1, 2])
def test_page_header_parse_matches_jax_and_oracle(tmp_path, tlib, jlib, version):
    raw = _synth_pages_file(tmp_path, version, C.SNAPPY)
    pages = 0
    for start, end in _page_offsets(raw):
        pos = start
        while pos < end:
            window = raw[pos : pos + (1 << 16)]
            assert np.array_equal(tlib.parse_page_header(window), jlib.parse_page_header(window))
            for cut in (1, 5):  # a window cut short: re-peek (None) in both
                assert tlib.parse_page_header(window[:cut]) is None
                assert jlib.parse_page_header(window[:cut]) is None
            t, j, o = io.BytesIO(raw), io.BytesIO(raw), io.BytesIO(raw)
            for f in (t, j, o):
                f.seek(pos)
            th = tchunk._read_page_header(t)
            jh = jchunk._read_page_header(j)
            oh = _strip_stats(tchunk.read_page_header_plain(o))
            assert repr(th) == repr(jh) == repr(oh)
            assert t.tell() == j.tell() == o.tell()
            pos = t.tell() + th.compressed_page_size
            pages += 1
    assert pages > 6


def test_corrupt_page_header_raises_the_readers_error(tlib, jlib):
    """Corrupt bytes: the native parser refuses them in both packages, and
    both read them again with the Python reader for its exact error."""
    bad = bytes([0x1F]) + b"\x00" * 16  # field 1 of wire type 15: no such type
    for lib in (tlib, jlib):
        with pytest.raises(ValueError, match="native: corrupt page header"):
            lib.parse_page_header(bad)
    with pytest.raises(tchunk.ChunkError) as t_err:
        tchunk._read_page_header(io.BytesIO(bad))
    with pytest.raises(jchunk.ChunkError) as j_err:
        jchunk._read_page_header(io.BytesIO(bad))
    assert str(t_err.value) == str(j_err.value)
    assert "cannot skip unknown type 15" in str(t_err.value)
    with pytest.raises(tchunk.ChunkError, match="eof"):
        tchunk._read_page_header(io.BytesIO(b""))


# -- items 4-6: the hybrid prescan and decode, the DELTA decode ----------------


def _hybrid_streams(width: int, seed: int = 7):
    """(label, stream, n): encoder output of mixed, all-RLE and all-packed
    values, and a hand-laid stream whose bit-packed runs are not adjacent."""
    rng = np.random.default_rng(seed + width)
    hi = 1 << min(width, 63) if width else 1
    out = []
    runs = np.repeat(rng.integers(0, hi, 40, dtype=np.uint64), rng.integers(1, 30, 40))
    for label, v in (("mixed", runs), ("all_rle", np.full(1000, hi - 1, np.uint64)),
                     ("all_packed", rng.integers(0, hi, 1001, dtype=np.uint64))):
        out.append((label, jhybrid.encode_hybrid(v, width), len(v)))
    if width:
        vb = (width + 7) // 8
        packed = rng.integers(0, 256, 2 * width, dtype=np.uint8).tobytes()
        rle = (16 << 1).to_bytes(1, "little") + (hi - 1 if width < 64 else 5).to_bytes(vb, "little")
        stream = bytes([(2 << 1) | 1]) + packed[:width * 2] + rle + bytes([(1 << 1) | 1]) \
            + packed[:width]
        out.append(("split_packed", stream, 40))
    return out


@pytest.mark.parametrize("width", [0, 1, 3, 8, 12, 17, 31, 32, 33, 63, 64])
def test_prescan_hybrid_matches_jax_and_oracle(width):
    for label, stream, n in _hybrid_streams(width):
        t = thybrid.prescan_hybrid(stream, n, width)
        j = jhybrid.prescan_hybrid(stream, n, width)
        o = thybrid.prescan_hybrid_plain(stream, n, width)
        for f in ("is_rle", "counts", "rle_values", "bp_offsets"):
            assert _same(getattr(t, f), getattr(j, f)), (label, f)
            assert _same(getattr(t, f), getattr(o, f)), (label, f)
        assert bytes(t.packed) == bytes(j.packed) == bytes(o.packed), label
        assert t.consumed == j.consumed == o.consumed, label


@pytest.mark.parametrize("width", [0, 1, 3, 8, 12, 17, 31, 32, 33, 63, 64])
def test_decode_hybrid_matches_jax_and_oracle(width):
    dtypes = [np.uint16, np.uint32, np.int32, np.uint64, np.int64] if width <= 16 else (
        [np.uint32, np.int32, np.uint64, np.int64] if width <= 32 else [np.uint64, np.int64])
    for label, stream, n in _hybrid_streams(width):
        for dt in dtypes:
            got = thybrid.decode_hybrid(stream, n, width, dtype=dt)
            assert _same(got, jhybrid.decode_hybrid(stream, n, width, dtype=dt)), (label, dt)
            assert _same(got, thybrid.decode_hybrid_plain(stream, n, width, dtype=dt)), (label, dt)
        assert _same(thybrid.decode_hybrid(stream, 0, width), jhybrid.decode_hybrid(stream, 0, width))


@pytest.mark.parametrize("stream,n,width", [
    (b"", 4, 3),  # no run header
    (b"\x00", 4, 3),  # an empty RLE run
    (b"\x01", 8, 3),  # an empty bit-packed run
    (b"\x03\x01", 8, 3),  # a bit-packed payload past the buffer
    (b"\x10\x09", 8, 3),  # an RLE value wider than the width
    (b"\x10", 8, 3),  # an RLE value past the buffer
])
def test_corrupt_hybrid_streams_raise_like_jax(stream, n, width):
    for fn in ("prescan_hybrid", "decode_hybrid"):
        with pytest.raises(thybrid.HybridError) as t_err:
            getattr(thybrid, fn)(stream, n, width)
        with pytest.raises(jhybrid.HybridError) as j_err:
            getattr(jhybrid, fn)(stream, n, width)
        assert str(t_err.value) == str(j_err.value)
        with pytest.raises(thybrid.HybridError):
            getattr(thybrid, fn + "_plain")(stream, n, width)
    with pytest.raises(thybrid.HybridError, match="invalid bit width"):
        thybrid.decode_hybrid(b"\x02\x00", 1, 65)


def _delta_values(nbits: int, kind: str, n: int, seed: int = 11):
    rng = np.random.default_rng(seed + n)
    dt = np.int32 if nbits == 32 else np.int64
    info = np.iinfo(dt)
    if kind == "wrap":  # deltas that overflow the type: min-delta wraps too
        v = np.where(np.arange(n) % 2 == 0, info.max, info.min).astype(dt)
        v[::7] = 0
        return v
    if kind == "full_range":
        return rng.integers(info.min, info.max, n, dtype=dt, endpoint=True)
    return np.cumsum(rng.integers(-50, 1000, n)).astype(dt)


@pytest.mark.parametrize("nbits", [32, 64])
@pytest.mark.parametrize("kind", ["ramp", "wrap", "full_range"])
def test_decode_delta_matches_jax_and_oracle(nbits, kind):
    for n in (0, 1, 2, 129, 1000):
        for block, minis in ((128, 4), (256, 8), (128, 1)):
            v = _delta_values(nbits, kind, n)
            stream = jdelta.encode_delta(v, nbits, block, minis) + b"\xfftail"
            got, used = tdelta.decode_delta(stream, nbits, max_total=n)
            want, w_used = jdelta.decode_delta(stream, nbits, max_total=n)
            o, o_used = tdelta.decode_delta_plain(stream, nbits, max_total=n)
            assert _same(got, want) and _same(got, o) and _same(got, v), (n, block)
            assert used == w_used == o_used == len(stream) - 5
            unbounded, _ = tdelta.decode_delta(stream, nbits)
            assert _same(unbounded, v)


@pytest.mark.parametrize("nbits", [32, 64])
@pytest.mark.parametrize("kind", ["ramp", "wrap", "full_range"])
def test_encode_delta_matches_jax_and_oracle(tlib, jlib, nbits, kind):
    for n in (0, 1, 2, 129, 1000):
        for block, minis in ((128, 4), (256, 8), (128, 1), (1024, 4)):
            v = _delta_values(nbits, kind, n)
            got = tdelta.encode_delta(v, nbits, block, minis)
            assert got == jdelta.encode_delta(v, nbits, block, minis), (n, block)
            assert got == tdelta.encode_delta_plain(v, nbits, block, minis), (n, block)
            assert got == tlib.delta_encode(v, nbits, block, minis)
    for block, minis in ((128, 3), (128, 32), (8192, 1024)):  # shapes no decoder takes
        with pytest.raises(tdelta.DeltaError, match="native: delta encode failed"):
            tdelta.encode_delta(np.arange(10), nbits, block, minis)
        with pytest.raises(ValueError, match="native: delta encode failed"):
            jlib.delta_encode(np.arange(10), nbits, block, minis)


@pytest.mark.parametrize("nbits", [32, 64])
def test_delta_errors_match_jax(nbits):
    v = _delta_values(nbits, "ramp", 300)
    stream = jdelta.encode_delta(v, nbits)
    cases = [(stream, 100),  # more values than the caller's bound
             (stream[:3], 300),  # a cut header
             (stream[: len(stream) // 2], 300),  # a payload past the buffer
             (b"\x80\x01\x04\x02\x00", 2)]  # block size 128, no block for the second value
    for data, bound in cases:
        with pytest.raises(tdelta.DeltaError) as t_err:
            tdelta.decode_delta(data, nbits, max_total=bound)
        with pytest.raises(jdelta.DeltaError) as j_err:
            jdelta.decode_delta(data, nbits, max_total=bound)
        assert str(t_err.value) == str(j_err.value)
        with pytest.raises(tdelta.DeltaError):
            tdelta.decode_delta_plain(data, nbits, max_total=bound)


# -- item 7: XXH64 and the bloom probe ------------------------------------------


def test_xxh64_matches_jax_and_the_spec(tlib, jlib):
    rng = np.random.default_rng(13)
    for n in list(range(0, 70)) + [100, 1000, 4099]:
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        for seed in (0, 1, (1 << 64) - 1):
            h = tlib.xxh64(data, seed)
            assert h == jlib.xxh64(data, seed) == tbloom.xxh64(data, seed)
    assert tlib.xxh64(b"") == 0xEF46DB3751D8E999  # the spec's empty-input digest


def test_bloom_probe_matches_jax():
    rng = np.random.default_rng(17)
    ints = rng.integers(-(1 << 40), 1 << 40, 500).astype(np.int64)
    words = [f"zone-{i}".encode() for i in range(300)] + ["東京".encode(), b""]
    for ptype, jtype, values, probes in (
        (T.INT64, JT.INT64, ints, list(ints[:50]) + list(range(100))),
        (T.BYTE_ARRAY, JT.BYTE_ARRAY, JBytes.from_list(words),
         words[:40] + [f"zone-{i}".encode() for i in range(300, 400)] + ["x", "東京"]),
        (T.DOUBLE, JT.DOUBLE, np.array([0.0, 1.5, -2.25]), [0.0, -0.0, 1.5, 3.0]),
    ):
        jbf = jbloom.BloomFilter.sized_for(len(values), 0.05)
        jbf.insert_hashes(jbloom.bloom_hash_values(jtype, values))
        tbf = tbloom.BloomFilter(jbf.blocks.copy())
        got = [tbf.might_contain(ptype, p) for p in probes]
        assert got == [jbf.might_contain(jtype, p) for p in probes]
        assert all(got[: len(probes) // 4])  # inserted values are never absent


# -- item 8: the hybrid encode -------------------------------------------------


def _encode_patterns(width: int, seed: int = 19):
    rng = np.random.default_rng(seed + width)
    hi = (1 << width) - 1
    top = np.uint64(hi)
    distinct = (np.arange(1001, dtype=np.uint64) * np.uint64(2654435761)) & top
    if width < 11:  # too narrow for 1,001 distinct values: no stretch of 8 repeats
        distinct = np.arange(1001, dtype=np.uint64) % np.uint64(min(hi + 1, 7))
    return {
        "random": rng.integers(0, hi, 1003, dtype=np.uint64, endpoint=True),
        "all_rle": np.full(1000, top, np.uint64),
        "all_packed": distinct,
        "mixed": np.repeat(rng.integers(0, hi, 60, dtype=np.uint64, endpoint=True),
                           rng.integers(1, 20, 60)),
        "short": np.full(5, top, np.uint64),
    }


@pytest.mark.parametrize("width", list(range(1, 65)))
def test_hybrid_encode_every_width_matches_jax_and_oracle(tlib, jlib, width):
    for label, v in _encode_patterns(width).items():
        got = thybrid.encode_hybrid(v, width)
        assert got == jhybrid.encode_hybrid(v, width), label
        assert got == thybrid.encode_hybrid_plain(v, width), label
        assert got == tlib.hybrid_encode(v, width) == jlib.hybrid_encode(v, width), label
        assert _same(thybrid.decode_hybrid(got, len(v), width, dtype=np.uint64), v), label
    if width < 64:
        wide = np.array([0, 1 << width], np.uint64)
        for lib in (tlib, jlib):
            with pytest.raises(ValueError, match=r"hybrid encode failed \(value too wide\)"):
                lib.hybrid_encode(wide, width)


def test_hybrid_encode_short_last_group_and_empty():
    """(9, 32): nearly every value bit-packed and n not a multiple of 8 (the
    short last group of ROADMAP §3): two padded groups, 65 bytes."""
    for n, width in ((9, 32), (17, 12), (1025, 31), (4097, 17), (0, 5), (3, 0), (8, 64)):
        v = np.arange(n, dtype=np.uint64)
        got = thybrid.encode_hybrid(v, width)
        assert got == jhybrid.encode_hybrid(v, width) == thybrid.encode_hybrid_plain(v, width)
    assert len(thybrid.encode_hybrid(np.arange(9, dtype=np.uint64), 32)) == 65


# -- item 9: the PLAIN byte-array encode ----------------------------------------


@pytest.mark.parametrize("label", ITEM_CASES)
def test_plain_encode_bytearray_matches_jax_and_oracle(tlib, jlib, label):
    items = _items(label)
    t, j = ByteArrayData.from_list(items), JBytes.from_list(items)
    want = jplain.encode_plain(j, JT.BYTE_ARRAY)
    assert tplain.encode_plain(t, T.BYTE_ARRAY) == want == _plain_stream(items)
    assert tplain.encode_plain(list(items), T.BYTE_ARRAY) == want
    assert tplain.plain_encode_bytearray_plain(t) == want
    assert tlib.plain_encode_bytearray(t.data, t.offsets) == jlib.plain_encode_bytearray(
        j.data, j.offsets)
    if items:  # offsets past the data: the same refusal
        bad = t.offsets.copy()
        bad[-1] += 5
        for lib in (tlib, jlib):
            with pytest.raises(ValueError, match="native: corrupt byte-array offsets"):
                lib.plain_encode_bytearray(t.data, bad)


# -- item 10: the byte-array min/max ---------------------------------------------


MINMAX_CASES = {
    "ties": [b"b", b"a", b"c", b"a", b"c", b"b"],
    "shared_prefix": [b"abc", b"ab", b"abd", b"a", b"abcd", b"ab\x00", b"abd"],
    "empty_strings": [b"x", b"", b"", b"\xff", b"\xff"],
    "one_row": [b"only"],
    "utf8": [w.encode() for w in ("zürich", "zurich", "東京", "ß", "z")],
    "long": [b"k" * 100, b"k" * 99 + b"l", b"a" * 70, b"\xff" * 80],
}


@pytest.mark.parametrize("label", sorted(MINMAX_CASES))
def test_bytes_minmax_matches_jax_and_oracle(tlib, jlib, label):
    items = MINMAX_CASES[label]
    t, j = ByteArrayData.from_list(items), JBytes.from_list(items)
    got = tlib.bytes_minmax(t.data, t.offsets)
    assert got == jlib.bytes_minmax(j.data, j.offsets) == tstats.bytes_minmax_plain(t)
    assert (items[got[0]], items[got[1]]) == (min(items), max(items))
    ts = tstats.compute_statistics(T.BYTE_ARRAY, t, 3)
    js = jstats.compute_statistics(JT.BYTE_ARRAY, j, 3)
    assert repr(ts) == repr(js)


def test_bytes_minmax_refuses_bad_offsets_like_jax(tlib, jlib):
    t = ByteArrayData.from_list([b"ab", b"c"])
    bad = t.offsets.copy()
    bad[-1] = 99
    for lib in (tlib, jlib):
        with pytest.raises(ValueError, match="native: byte-array minmax failed"):
            lib.bytes_minmax(t.data, bad)


# -- item 11: the dictionary probes ----------------------------------------------


@pytest.mark.parametrize("uniques", [1, 300, DICT_MAX_UNIQUES, DICT_MAX_UNIQUES + 1])
def test_bytes_dictionary_probe_at_the_cutoff(tlib, jlib, uniques):
    rng = np.random.default_rng(uniques)
    keys = [f"k{i}-{'é' * (i % 3)}".encode() for i in range(uniques)]
    rows = [keys[i] for i in rng.permutation(np.arange(2 * uniques) % uniques)] + [b""]
    t, j = ByteArrayData.from_list(rows), JBytes.from_list(rows)
    got = tlib.bytes_dict_indices(t.data, t.offsets, DICT_MAX_UNIQUES)
    want = jlib.bytes_dict_indices(j.data, j.offsets, DICT_MAX_UNIQUES)
    oracle = _bytes_first_occurrence_dictionary(t)
    if uniques + 1 > DICT_MAX_UNIQUES:  # the empty string is one more unique
        assert got is None and want is None and oracle is None
    else:
        for a, b in ((got, want), (got, oracle)):
            assert _same(a[0], b[0]) and _same(a[1], b[1])
    schema = "message m { required binary s (UTF8); }"
    jb = JBuilder(parse_schema(schema).column("s"), True)
    tb = ColumnChunkBuilder(Schema.from_thrift(parse_schema(schema).to_thrift()).column("s"), True)
    td, jd = tb.build_dictionary(t), jb.build_dictionary(j)
    assert (td is None) == (jd is None)
    if td is not None:
        assert _same(td[0], jd[0]) and _same(td[1], np.asarray(jd[1], dtype=np.uint32))


def _numeric_keys(dtype, uniques: int):
    """`uniques` distinct bit patterns of `dtype`, NaN payloads and both zeros
    among them."""
    it = np.dtype(dtype).itemsize
    bits = np.arange(uniques, dtype=np.uint32 if it == 4 else np.uint64)
    vals = bits.view(dtype).copy() if np.dtype(dtype).kind != "f" else None
    if vals is None:
        u = np.uint32 if it == 4 else np.uint64
        exp = u(0x7F800000) if it == 4 else u(0x7FF0000000000000)
        # quiet and signalling NaNs with distinct payloads, then +/-0.0, then numbers
        specials = np.array([exp | u(1), exp | u(2), exp | u(1 << 20), u(0),
                             u(0x80000000) if it == 4 else u(1 << 63)], dtype=u)
        rest = (np.arange(uniques, dtype=np.float64) + 1.5).astype(dtype).view(u)
        vals = np.concatenate([specials, rest])[:uniques].view(dtype)
    return vals


@pytest.mark.parametrize("dtype", ["int32", "int64", "float32", "float64"])
@pytest.mark.parametrize("uniques", [5, DICT_MAX_UNIQUES, DICT_MAX_UNIQUES + 1])
def test_numeric_dictionary_probe_at_the_cutoff(tlib, jlib, dtype, uniques):
    rng = np.random.default_rng(uniques)
    keys = _numeric_keys(dtype, uniques)
    vals = keys[rng.permutation(np.arange(2 * uniques) % uniques)]
    bits = vals.view(np.uint32 if vals.itemsize == 4 else np.uint64)
    got = tlib.u64_dict_indices(bits, DICT_MAX_UNIQUES)
    want = jlib.u64_dict_indices(bits, DICT_MAX_UNIQUES)
    firsts, indices = _first_occurrence_dictionary(bits)
    if uniques > DICT_MAX_UNIQUES:
        assert got is None and want is None and len(firsts) > DICT_MAX_UNIQUES
    else:
        for a in (got[0], want[0], firsts):
            assert np.array_equal(a.astype(np.int64), firsts.astype(np.int64))
        for a in (got[1], want[1], indices):
            assert _same(np.asarray(a, dtype=np.uint32), indices)
    wide = tlib.u64_dict_indices(bits.astype(np.uint64), DICT_MAX_UNIQUES)  # 8-byte lanes
    assert (wide is None) == (got is None)
    physical = {"int32": "int32", "int64": "int64", "float32": "float", "float64": "double"}
    schema = f"message m {{ required {physical[dtype]} a; }}"
    jb = JBuilder(parse_schema(schema).column("a"), True)
    tb = ColumnChunkBuilder(Schema.from_thrift(parse_schema(schema).to_thrift()).column("a"), True)
    td, jd = tb.build_dictionary(vals), jb.build_dictionary(vals)
    assert (td is None) == (jd is None)
    if td is not None:
        assert td[0].tobytes() == jd[0].tobytes()
        assert _same(td[1], np.asarray(jd[1], dtype=np.uint32))


# -- every call site answers through the host library --------------------------


def _sites():
    items = [b"ab", b"", "é".encode()]
    col = ByteArrayData.from_list(items)
    hybrid = jhybrid.encode_hybrid(np.arange(20, dtype=np.uint64) % 3, 2)
    header = io.BytesIO(bytes([0x15, 0x00, 0x15, 0x04, 0x15, 0x04, 0x2C, 0x15, 0x02,
                               0x15, 0x00, 0x15, 0x00, 0x15, 0x00, 0x00, 0x00]))
    schema = Schema.from_thrift(parse_schema(
        "message m { required binary s (UTF8); required int64 a; }").to_thrift())
    bf = tbloom.BloomFilter(np.zeros(8, dtype=np.uint32))
    return {
        "byte_array_gather": lambda: tplain.decode_plain(_plain_stream(items), 3, T.BYTE_ARRAY),
        "bytearray_take": lambda: col.take([2, 0]),
        "parse_page_header": lambda: tchunk._read_page_header(header),
        "prescan_hybrid": lambda: thybrid.prescan_hybrid(hybrid, 20, 2),
        "hybrid_decode": lambda: thybrid.decode_hybrid(hybrid, 20, 2),
        "delta_decode": lambda: tdelta.decode_delta(jdelta.encode_delta([1, 2, 3], 64), 64),
        "delta_encode": lambda: tdelta.encode_delta(np.arange(300), 64),
        "xxh64": lambda: bf.might_contain(T.INT64, 5),
        "hybrid_encode": lambda: thybrid.encode_hybrid(np.arange(20) % 3, 2),
        "plain_encode_bytearray": lambda: tplain.encode_plain(col, T.BYTE_ARRAY),
        "bytes_minmax": lambda: tstats.compute_statistics(T.BYTE_ARRAY, col, 0),
        "bytes_dict_indices": lambda: ColumnChunkBuilder(
            schema.column("s"), True).build_dictionary(col),
        "u64_dict_indices": lambda: ColumnChunkBuilder(
            schema.column("a"), True).build_dictionary(np.arange(50) % 4),
    }


SITES = sorted(_sites())


@pytest.mark.parametrize("site", SITES)
def test_call_sites_raise_host_build_error_without_the_library(monkeypatch, site):
    call = _sites()[site]
    call()  # answers with the library
    monkeypatch.setattr(tnative, "_cached", None)

    def no_library():
        raise host_build.HostBuildError("host library build failed (1): g++ ...")

    monkeypatch.setattr(host_build, "load", no_library)
    call = _sites()[site]
    with pytest.raises(host_build.HostBuildError, match="build failed"):
        call()


# -- every ctypes argument has its C parameter's width -------------------------


_C_TYPES = {
    "size_t": ctypes.c_size_t, "ssize_t": ctypes.c_ssize_t, "int": ctypes.c_int,
    "int64_t": ctypes.c_int64, "uint64_t": ctypes.c_uint64, "void": None,
}


def _c_definitions():
    defs = {}
    for name in host_build.CXX_SOURCES:
        src = (host_build.NATIVE / name).read_text()
        for m in re.finditer(r"^(ssize_t|size_t|uint64_t|void) (ptq_\w+)\(([^)]*)\) \{",
                             src, re.M):
            params = [" ".join(p.split()) for p in m.group(3).split(",")]
            defs[m.group(2)] = (m.group(1), params)
    return defs


def test_host_signatures_match_the_sources(tlib):
    """Every function the host sources define is bound, and every argument
    and result ctypes passes has its C type's width: a Python int bound as
    c_int where the source takes int64_t would be cut to 32 bits without an
    error."""
    defs = _c_definitions()
    assert {"ptq_xxh64", "ptq_byte_array_gather", "ptq_hybrid_decode", "ptq_delta_decode",
            "ptq_delta_peek_total", "ptq_bytearray_take", "ptq_plain_encode_bytearray",
            "ptq_parse_page_header", "ptq_prescan_hybrid", "ptq_hybrid_encode",
            "ptq_bytes_dict_indices", "ptq_bytes_minmax", "ptq_u64_dict_indices"} <= set(defs)
    for name, (ret, params) in defs.items():
        fn = getattr(tlib._lib, name)
        want = [ctypes.c_void_p if "*" in p else _C_TYPES[re.sub(r"\s+\w+$", "", p)]
                for p in params]
        assert list(fn.argtypes) == want, name
        assert fn.restype == _C_TYPES[ret], name
        assert ctypes.sizeof(fn.restype) == 8, name


def test_value_functions_build_from_their_own_source():
    assert "values.cc" in host_build.SOURCES and "bits.h" in host_build.SOURCES
    assert host_build.CXX_SOURCES == ("prepare.cc", "values.cc")
    src = (host_build.NATIVE / "values.cc").read_text()
    assert '#include "bits.h"' in src and '#include "parquet_tpu_native.h"' not in src


# -- reader and writer parity on a small taxi-shaped file ----------------------


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


ROWS, RG_ROWS = 4000, 2000


def _taxi_specs(seed: int = 23):
    """chip_smoke.py's taxi columns at 4,000 rows, `zone` with empty and
    multibyte strings, and `zone_mixed`, a SNAPPY V1 dictionary column that
    falls back to PLAIN pages past 4 KiB (pyarrow's default shape)."""
    rng = np.random.default_rng(seed)
    n = ROWS
    runs = rng.integers(20, 500, size=n // 20 + 2)
    vendor = np.repeat(rng.integers(0, 8, size=len(runs)).astype(np.int32), runs)[:n]
    valid = rng.random(n) >= 0.05
    passengers = rng.choice(7, size=int(valid.sum()))
    pickup = 1_700_000_000_000_000 + np.cumsum(rng.integers(-2_000_000, 60_000_000, size=n))
    zones = ByteArrayData.from_list(
        [b"" if i % 13 == 0 else f"zöne-{i:05d}-{'東' * (i % 4)}".encode() for i in range(900)])
    return [
        ColumnSpec("trip_id", T.INT64, values=np.arange(n, dtype=np.int64) + 10**9),
        ColumnSpec("vendor_id", T.INT32, encoding=E.RLE_DICTIONARY, codec=C.GZIP,
                   page_version=2, dictionary=np.arange(1, 9, dtype=np.int32), indices=vendor),
        ColumnSpec("passenger_count", T.INT32, encoding=E.RLE_DICTIONARY, codec=C.GZIP,
                   valid=valid, dictionary=np.arange(7, dtype=np.int32),
                   indices=passengers.astype(np.int32)),
        ColumnSpec("pickup_us", T.INT64, values=pickup.astype(np.int64),
                   encoding=E.DELTA_BINARY_PACKED, codec=C.GZIP, page_version=2),
        ColumnSpec("fare_cents", T.INT32, values=rng.gamma(2.0, 900.0, n).astype(np.int32),
                   encoding=E.DELTA_BINARY_PACKED, page_version=2),
        ColumnSpec("trip_distance", T.DOUBLE, encoding=E.RLE_DICTIONARY, codec=C.GZIP,
                   dictionary=np.round(rng.gamma(1.5, 2.5, size=256), 2),
                   indices=rng.integers(0, 256, size=n, dtype=np.int32)),
        ColumnSpec("zone", T.BYTE_ARRAY, encoding=E.RLE_DICTIONARY, codec=C.GZIP,
                   dictionary=zones, utf8=True, indices=rng.integers(0, 900, n, dtype=np.int32)),
        ColumnSpec("zone_mixed", T.BYTE_ARRAY, encoding=E.RLE_DICTIONARY, codec=C.SNAPPY,
                   dictionary=zones, utf8=True, dict_fallback_bytes=4096,
                   indices=rng.integers(0, 900, n, dtype=np.int32)),
    ]


@pytest.fixture(scope="module")
def taxi_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("taxi") / "taxi-small.parquet"
    specs = _taxi_specs()
    write_file(path, specs, row_group_rows=RG_ROWS, page_bytes=4096)
    return path, specs


def _port_read(path, walk: str):
    if walk == "host":
        with FileReader(path, device="cpu") as r:
            return [r.read_row_group(i) for i in range(r.num_row_groups)]
    with _env(PQT_FUSED_PREPARE="1" if walk == "fused" else "0"):
        tpipe.reset_prepare_counts()
        with FileReader(path, backend="device_roundtrip", device="cpu") as r:
            groups = [r.read_row_group(i) for i in range(r.num_row_groups)]
            chunks = r.num_row_groups * len(r.schema.leaves)
        counts = tpipe.prepare_counts()
    if walk == "fused":
        assert counts == {"prepare_fused_engaged": chunks}, counts
    else:
        assert not counts.get("prepare_fused_engaged"), counts
    return groups


@pytest.mark.parametrize("walk", ["host", "staged", "fused"])
def test_taxi_reads_equal_the_jax_reader(taxi_file, walk):
    path, specs = taxi_file
    groups = _port_read(path, walk)
    with JReader(str(path)) as jr:
        want = [jr.read_row_group(i) for i in range(jr.num_row_groups)]
    assert len(groups) == len(want) == ROWS // RG_ROWS
    for g, w in zip(groups, want):
        assert g.keys() == w.keys()
        for p in g:
            for f in ("values", "def_levels", "rep_levels"):
                assert _same(getattr(g[p], f), getattr(w[p], f)), (walk, p, f)
    zone = ByteArrayData(
        offsets=np.concatenate([[0], np.cumsum(np.concatenate(
            [np.diff(g[("zone_mixed",)].values.offsets) for g in groups]))]).astype(np.int64),
        data=b"".join(g[("zone_mixed",)].values.data for g in groups))
    assert zone == column_values(specs[-1])


def test_taxi_file_takes_plain_fallback_pages(taxi_file):
    """zone_mixed falls back to PLAIN pages: the read above ran the native
    gather on both the dictionary page and the fallback pages."""
    from parquet_tpu_torch.meta.parquet_types import Encoding

    path, _specs = taxi_file
    with FileReader(path, device="cpu") as r:
        for i in range(r.num_row_groups):
            cc = next(c for c in r.row_group(i).columns
                      if c.meta_data.path_in_schema == ["zone_mixed"])
            assert Encoding.PLAIN in cc.meta_data.encodings


TAXI_DSL = """
message taxi {
  required int64 trip_id;
  required int32 vendor_id;
  optional int32 passenger_count;
  required int64 pickup_us;
  required int32 fare_cents;
  required double trip_distance;
  required binary zone (UTF8);
}
"""


@pytest.mark.parametrize("dictionary", ["probed", "off"])
def test_taxi_host_write_equals_the_jax_write(taxi_file, dictionary):
    """The write phase's shape (SNAPPY, V1, dictionaries probed on five
    columns and on zone, DELTA on two): the port's host write of the
    columns equals the JAX package's, byte for byte."""
    _path, specs = taxi_file
    vals = {s.name: column_values(s) for s in specs}
    valid = specs[2].valid
    js = parse_schema(TAXI_DSL)
    ts = Schema.from_thrift(js.to_thrift())
    use = ["trip_id", "vendor_id", "passenger_count", "pickup_us", "trip_distance", "zone"]
    opts = dict(codec="snappy", data_page_version=1, max_page_size=4096,
                use_dictionary=use if dictionary == "probed" else False,
                column_encodings={"pickup_us": "DELTA_BINARY_PACKED",
                                  "fare_cents": "DELTA_BINARY_PACKED"})
    out = {}
    for pkg, W, M, schema, B in (("jax", JWriter, JMemorySink, js, JBytes),
                                 ("torch", FileWriter, MemorySink, ts, ByteArrayData)):
        sink = M()
        w = W(sink, schema, **opts)
        for g in range(ROWS // RG_ROWS):
            r0, r1 = g * RG_ROWS, (g + 1) * RG_ROWS
            for name in (s.name for s in specs if s.name != "zone_mixed"):
                v = vals[name]
                if name == "passenger_count":
                    cells = np.concatenate([[0], np.cumsum(valid)])
                    w.write_column(name, v[cells[r0]: cells[r1]],
                                   def_levels=valid[r0:r1].astype(np.uint16))
                elif isinstance(v, ByteArrayData):
                    o = v.offsets[r0: r1 + 1]
                    w.write_column(name, B(offsets=o - o[0], data=v.data[o[0]: o[-1]]))
                else:
                    w.write_column(name, v[r0:r1])
            w.flush_row_group()
        w.close()
        out[pkg] = sink.getvalue()
    assert out["torch"] == out["jax"]
    with FileReader(out["torch"], device="cpu") as r:
        st = r.metadata.row_groups[0].columns[6].meta_data.statistics
        zone0 = ByteArrayData(offsets=vals["zone"].offsets[: RG_ROWS + 1],
                              data=vals["zone"].data).to_list()
        assert st.min_value == min(zone0) and st.max_value == max(zone0)
