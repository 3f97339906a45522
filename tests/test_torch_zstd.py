"""The port's native ZSTD codec (native/zstd.cc over libzstd, built at the
first ZSTD use into libpqt_zstd.so) against the reference's zstandard
codec: the golden ZSTD file reads with no codec registered, equal to the
reference, through FileReader and `parquet-tool cat`; a port ZSTD write
reads back through the reference; where libzstd cannot build, ZSTD is the
typed "not registered" CompressionError naming the missing header; a
registered codec takes precedence; libpqt_host.so does not link libzstd."""

import contextlib
import io
import subprocess
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
zstandard = pytest.importorskip("zstandard")

import parquet_tpu.kernels.device_ops  # noqa: E402,F401  (turns x64 on first)
from parquet_tpu.core.reader import FileReader as JReader  # noqa: E402
from parquet_tpu.tools.parquet_tool import main as jmain  # noqa: E402

from parquet_tpu_torch import FileReader, FileWriter, parse_schema  # noqa: E402
from parquet_tpu_torch.core import compress as tcompress  # noqa: E402
from parquet_tpu_torch.core.compress import CompressionError  # noqa: E402
from parquet_tpu_torch.kernels import host_build  # noqa: E402
from parquet_tpu_torch.meta.parquet_types import CompressionCodec  # noqa: E402
from parquet_tpu_torch.tools.parquet_tool import main as tmain  # noqa: E402

GOLDEN = Path(__file__).parent / "golden" / "data"
ZSTD_FILE = GOLDEN / "alltypes_zstd_v2_nodict.parquet"
ZSTD = int(CompressionCodec.ZSTD)


def _native():
    impl = tcompress._REGISTRY[ZSTD]
    assert isinstance(impl, tcompress._NativeZstd)
    return impl


def _rows(reader_cls, path, **kw):
    with reader_cls(str(path), **kw) as r:
        return list(r.iter_rows())


def test_golden_zstd_file_reads_with_no_codec_registered():
    assert type(tcompress._REGISTRY[ZSTD]) is tcompress._NativeZstd
    assert _rows(FileReader, ZSTD_FILE, device="cpu") == _rows(JReader, ZSTD_FILE)


@pytest.mark.parametrize("backend", ["host", "device_roundtrip"])
def test_golden_zstd_columns_equal_the_reference(backend):
    with JReader(str(ZSTD_FILE)) as jr, FileReader(str(ZSTD_FILE), backend=backend,
                                                   device="cpu") as r:
        for i in range(r.num_row_groups):
            got, want = r.read_row_group(i), jr.read_row_group(i)
            assert got.keys() == want.keys()
            for p in got:
                a, b = got[p].values, want[p].values
                if hasattr(a, "offsets"):
                    assert bytes(a.data) == bytes(b.data)
                    assert np.array_equal(a.offsets, b.offsets)
                else:
                    assert np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True)


def test_parquet_tool_cat_reads_zstd():
    outs = []
    for main in (jmain, tmain):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(["cat", str(ZSTD_FILE)]) == 0
        outs.append(buf.getvalue())
    assert outs[1] == outs[0] and outs[1].count("\n") == 1500


@pytest.mark.parametrize("n", [0, 1, 1000, 300_000])
def test_port_zstd_write_reads_back_through_the_reference(n, tmp_path):
    rng = np.random.default_rng(n)
    schema = parse_schema("message m { required int64 a; optional binary s (STRING); }")
    path = tmp_path / "z.parquet"
    a = rng.integers(-(2**40), 2**40, n)
    s = [None if i % 7 == 0 else f"v{int(x) % 1000}" for i, x in enumerate(a)]
    with FileWriter(str(path), schema, codec="zstd") as w:
        w.write_rows([{"a": int(x), "s": y} for x, y in zip(a, s)])
    got = _rows(JReader, path)
    assert [r["a"] for r in got] == [int(x) for x in a]
    assert [r["s"] for r in got] == s
    with JReader(str(path)) as jr:
        for rg in jr.metadata.row_groups:
            assert {c.meta_data.codec for c in rg.columns} == {ZSTD}


@pytest.mark.parametrize("size", [0, 1, 777, 1 << 20])
def test_compressed_bytes_against_zstandard(size):
    """Decompression agrees both ways at every size. The compressed bytes
    are held equal only where this image's libzstd and zstandard's bundled
    zstd are the same release: the test says which it found."""
    data = (np.random.default_rng(size).integers(0, 16, size, dtype=np.uint8)).tobytes()
    z = _native()
    ours, theirs = z.compress(data), zstandard.ZstdCompressor().compress(data)
    assert z.decompress(theirs, size) == data
    assert zstandard.ZstdDecompressor().decompress(ours, max_output_size=max(size, 1)) == data
    bundled = ".".join(map(str, zstandard.ZSTD_VERSION))
    if z.version() == bundled:
        assert ours == theirs, f"libzstd {z.version()} = bundled {bundled}, bytes differ"
    else:
        print(f"libzstd {z.version()} != zstandard's bundled {bundled}: bytes not compared")


def test_corrupt_and_oversized_streams_raise_typed():
    z = _native()
    good = z.compress(b"x" * 1000)
    with pytest.raises(CompressionError):
        tcompress.decompress_block(good[:-3], ZSTD, 1000)
    with pytest.raises(CompressionError):
        tcompress.decompress_block(good, ZSTD, 999)  # inflates past the advertised size
    with pytest.raises(CompressionError):
        tcompress.decompress_block(b"not zstd at all", ZSTD, 10)
    assert tcompress.decompress_block(good, ZSTD, 1000) == b"x" * 1000


def test_each_thread_keeps_its_own_context():
    z = _native()
    blobs = [(bytes([k]) * (50_000 + k), None) for k in range(16)]
    blobs = [(d, z.compress(d)) for d, _ in blobs]
    errors = []

    def work(k):
        try:
            for _ in range(20):
                d, c = blobs[(k * 7 + _) % len(blobs)]
                assert z.decompress(c, len(d)) == d
                assert z.decompress(z.compress(d), len(d)) == d
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=work, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
        assert not t.is_alive()
    assert not errors
    src = (host_build.NATIVE / "zstd.cc").read_text()
    assert "thread_local Contexts ctx;" in src


def test_missing_header_is_the_typed_refusal(monkeypatch, tmp_path):
    """A host without zstd.h: the build fails, ZSTD stays unregistered and
    every use raises the typed CompressionError naming the header."""
    from parquet_tpu_torch.utils.native import get_native

    get_native()  # the host library (not ZSTD's) loads from the real sources
    src = tmp_path / "native"
    src.mkdir()
    (src / "zstd.cc").write_text((host_build.NATIVE / "zstd.cc").read_text())
    monkeypatch.setattr(host_build, "NATIVE", src)
    monkeypatch.setattr(host_build, "BUILD_ROOT", tmp_path / "build")
    # a compiler that searches no system include directory cannot find zstd.h
    real_cxx = host_build._cxx()
    shim = tmp_path / "cxx"
    shim.write_text(f'#!/bin/sh\nexec {real_cxx} -nostdinc++ -nostdinc "$@"\n')
    shim.chmod(0o755)
    monkeypatch.setenv("CXX", str(shim))
    monkeypatch.setattr(host_build, "_zstd", None)
    monkeypatch.setattr(host_build, "_zstd_error", None)
    impl = tcompress._NativeZstd()
    monkeypatch.setitem(tcompress._REGISTRY, ZSTD, impl)
    for call in (lambda: tcompress.decompress_block(b"x", ZSTD, 1),
                 lambda: tcompress.compress_block(b"x", ZSTD)):
        with pytest.raises(CompressionError) as e:
            call()
        assert "compression codec ZSTD not registered" in str(e.value)
        assert "zstd.h not found" in str(e.value)
    assert not tcompress.codec_supported(CompressionCodec.ZSTD)
    with pytest.raises(host_build.HostBuildError, match="zstd.h not found"):
        host_build.load_zstd()  # kept, not rebuilt
    with pytest.raises(CompressionError, match="not registered"):
        _rows(FileReader, ZSTD_FILE, device="cpu")


def test_a_registered_codec_takes_precedence(monkeypatch):
    calls = []

    class Spy:
        name = "ZSTD"

        def compress(self, data):
            return zstandard.ZstdCompressor().compress(bytes(data))

        def decompress(self, data, n):
            calls.append(n)
            return zstandard.ZstdDecompressor().decompress(bytes(data), max_output_size=max(n, 1))

    monkeypatch.setitem(tcompress._REGISTRY, ZSTD, Spy())
    assert _rows(FileReader, ZSTD_FILE, device="cpu") == _rows(JReader, ZSTD_FILE)
    assert calls
    monkeypatch.undo()
    assert isinstance(tcompress._REGISTRY[ZSTD], tcompress._NativeZstd)


def test_host_library_does_not_link_libzstd():
    from parquet_tpu_torch.utils.native import get_native

    host = get_native()._lib._name
    zstd = host_build.load_zstd()._name
    assert Path(zstd).name == host_build.ZSTD_LIB_NAME and Path(host).parent != Path(zstd).parent
    ldd = subprocess.run(["ldd", host], capture_output=True, text=True).stdout
    assert "libzstd" not in ldd
    assert "libzstd" in subprocess.run(["ldd", zstd], capture_output=True, text=True).stdout
    assert "zstd.cc" not in host_build.SOURCES and "-lzstd" not in " ".join(host_build.CXX_FLAGS)
